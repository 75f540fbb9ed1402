"""Build and load the port's CUDA kernels.

Each ``predictionio_torch/csrc/*.cu`` source compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``build/torch_kernels/`` at the root of the checkout, named by a digest of
the source and the flags, so an unchanged source is built once per
checkout and concurrent processes never load a half-written file.

Nothing is built at import: the first launch of a kernel builds it.
nvcc's ``-Xptxas -v`` report (registers, stack frame, spills per kernel)
is kept beside each library, so a library built earlier still has it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: (nvcc seconds, 0.0 when the library was already built;
# nvcc's -Xptxas -v report: registers, shared memory, spills)
build_log: dict[str, tuple[float, str]] = {}
_REPORT_SUFFIX = ".ptxas.txt"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's CUDA kernels build from source at first use")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.blake2b(src + repr(NVCC_FLAGS).encode(),
                             digest_size=8).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def build(names: Sequence[str]) -> None:
    """Build every named source that has no library yet, one nvcc per
    source, all started together. Raises RuntimeError with nvcc's output
    when a build fails."""
    running = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            report = out.with_name(out.name + _REPORT_SUFFIX)
            build_log.setdefault(name, (0.0, report.read_text()
                                        if report.exists() else ""))
            continue
        running.append((name, out, *_start_build(name)))
    errors = []
    for name, out, proc, tmp, t0 in running:
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{report}")
            continue
        out.with_name(out.name + _REPORT_SUFFIX).write_text(report)
        os.replace(tmp, out)
        build_log[name] = (seconds, report)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def ptxas_kernels(report: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of an ``-Xptxas -v`` report: registers,
    stack frame bytes, spill store and spill load bytes."""
    kernels: dict[str, dict[str, int]] = {}
    current = None
    for line in report.splitlines():
        if "Function properties for " in line:
            current = kernels.setdefault(line.split()[-1], {})
        elif current is not None and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            current.update(stack=nums[0], spill_stores=nums[1],
                           spill_loads=nums[2])
        elif current is not None and "Used " in line and "registers" in line:
            words = line.split()
            current["registers"] = int(words[words.index("Used") + 1])
    return kernels


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
