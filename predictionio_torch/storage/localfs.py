"""LocalFS model-blob backend — own copy of the reference's
``predictionio_tpu/storage/localfs.py``.

Parity with «storage/localfs/.../LocalFSModels.scala» (SURVEY.md §2.2
'LocalFS/HDFS/S3 model stores' [U]): model blobs as files on the local
filesystem — the right home for multi-hundred-MB factor matrices that
shouldn't live as SQLite rows. Only the `models()` repository is backed;
a LocalFS source wired as METADATA or EVENTDATA fails fast with a clear
message (the reference's localfs backend likewise only implements Models).

Writes are atomic (temp file + os.replace) so a crashed train never
leaves a half-written blob where `pio deploy` will read.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from predictionio_torch.storage import base
from predictionio_torch.storage.base import Model

log = logging.getLogger(__name__)


def _current_umask() -> int:
    mask = os.umask(0)
    os.umask(mask)
    return mask


class LocalFSModels(base.Models):
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # sweep temp files orphaned by a hard-killed writer (mkstemp done,
        # os.replace never reached). Age-gated: another live process may be
        # mid-write in this same directory (train writes, deploy reads)
        import time

        cutoff = time.time() - 3600
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                p = os.path.join(self.directory, name)
                try:
                    if os.path.getmtime(p) < cutoff:
                        os.unlink(p)
                except OSError:
                    pass

    def _path(self, model_id: str) -> str:
        # model ids are storage-generated hex strings; refuse anything that
        # could escape the directory
        if not model_id or any(c in model_id for c in "/\\\0") or ".." in model_id:
            raise ValueError(f"Invalid model id {model_id!r}")
        return os.path.join(self.directory, f"{model_id}.model")

    def insert(self, model: Model) -> None:
        path = self._path(model.id)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            # mkstemp creates 0600; widen to umask-honoring 0666&~umask so
            # a deploy process under another user/group can read the blob
            os.fchmod(fd, 0o666 & ~_current_umask())
            with os.fdopen(fd, "wb") as f:
                f.write(model.models)
                f.flush()
                os.fsync(f.fileno())  # rename must land on durable data
            os.replace(tmp, path)
            # fsync the directory too, else the rename itself can be lost
            # on power failure
            dirfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, model_id: str) -> Optional[Model]:
        path = self._path(model_id)
        try:
            with open(path, "rb") as f:
                return Model(id=model_id, models=f.read())
        except FileNotFoundError:
            return None

    def delete(self, model_id: str) -> bool:
        try:
            os.unlink(self._path(model_id))
            return True
        except FileNotFoundError:
            return False


class LocalFSBackend(base.StorageBackend):
    """Models-only storage source (type "localfs")."""

    def __init__(self, directory: str):
        # resolve + create once, so a relative PATH binds to the CWD at
        # construction (not at each models() call) and repos share one store
        self._models = LocalFSModels(directory)
        self.directory = self._models.directory

    def _unsupported(self, repo: str):
        raise NotImplementedError(
            f"The localfs backend only provides model blobs; wire {repo} to "
            "a sqlite/memory source (PIO_STORAGE_REPOSITORIES_*_SOURCE).")

    def apps(self):
        self._unsupported("apps")

    def access_keys(self):
        self._unsupported("access_keys")

    def channels(self):
        self._unsupported("channels")

    def engine_instances(self):
        self._unsupported("engine_instances")

    def evaluation_instances(self):
        self._unsupported("evaluation_instances")

    def models(self) -> LocalFSModels:
        return self._models

    def events(self):
        self._unsupported("events")
