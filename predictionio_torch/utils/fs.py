"""Filesystem conventions — own copy of the reference's
``predictionio_tpu/utils/fs.py``."""

from __future__ import annotations

import os


def fs_basedir(env=None) -> str:
    """THE local working directory (`PIO_FS_BASEDIR`, default
    `~/.pio_tpu`, the reference's, so both packages find one store) — the
    reference's `pio.home`/`PIO_FS_BASEDIR` analogue. Storage defaults
    root here; resolve it only through this helper so the fallback cannot
    drift between subsystems. `env` overrides the environment consulted
    (the storage registry's explicit-env contract)."""
    if env is None:
        env = os.environ
    return env.get(
        "PIO_FS_BASEDIR", os.path.join(os.path.expanduser("~"), ".pio_tpu"))
