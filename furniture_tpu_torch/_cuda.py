"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
(listed in ``.gitignore``) at first use, and loaded with ``ctypes``. The
library's name carries a hash of the source, of the headers beside it
(``csrc/*.cuh``) and of the flags, so an edited source is rebuilt. The ``-Xptxas -v`` register and shared-memory report is
kept beside the library (``.log``).

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on the PATH. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def start_build(source: Path):
    """Start compiling ``source`` unless its library exists; returns the
    running ``subprocess.Popen`` (or None) so several builds can overlap."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.furniture_paths = (tmp, out)
    return proc


def finish_build(proc) -> None:
    """Wait for a build from :func:`start_build`; raises if it failed."""
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp, out = proc.furniture_paths
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {out.name}:\n{log}")
    os.replace(tmp, out)


def build_log(source: Path) -> str:
    """The compiler's report for the built library of ``source``."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load it."""
    finish_build(start_build(source))
    return ctypes.CDLL(str(library_path(source)))
