"""ctypes binding of the native trajectory store (``native/traj_store.cpp``).

The port's counterpart of ``furniture_tpu.utils.traj_store``, on the same
C++ source. The library is compiled with ``g++`` at first use into
``furniture_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags, so an edited source is rebuilt.
A failed build raises; there is no other route.

Usage::

    with TrajStore("demos.ftr", "w") as ts:
        ts.append(actions, rewards)            # [T,A], [T] float32
    with TrajStore("demos.ftr", "r") as ts:
        actions, rewards, extras = ts.read(0)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "traj_store.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"traj_store-{h.hexdigest()[:16]}.so"


def _build_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.stem}.{os.getpid()}.tmp.so")
        out = subprocess.run(
            ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({out.returncode}) for {SOURCE.name}:\n{out.stderr}"
            )
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    fptr = ctypes.POINTER(ctypes.c_float)
    u32 = ctypes.c_uint32
    lib.ts_open.restype = ctypes.c_void_p
    lib.ts_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ts_append.restype = ctypes.c_int
    lib.ts_append.argtypes = [ctypes.c_void_p, fptr, fptr, fptr, u32, u32, u32]
    lib.ts_flush.argtypes = [ctypes.c_void_p]
    lib.ts_count.restype = ctypes.c_int
    lib.ts_count.argtypes = [ctypes.c_void_p]
    lib.ts_record_info.restype = ctypes.c_int
    lib.ts_record_info.argtypes = [ctypes.c_void_p, u32, ctypes.POINTER(u32)]
    lib.ts_read.restype = ctypes.c_int
    lib.ts_read.argtypes = [ctypes.c_void_p, u32, fptr, fptr, fptr]
    lib.ts_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class TrajStore:
    """Append-only trajectory store with a background native writer thread."""

    def __init__(self, path: str | os.PathLike, mode: str = "r"):
        self._lib = _build_lib()
        self._h = self._lib.ts_open(str(path).encode(), mode.encode())
        if not self._h:
            raise OSError(f"traj_store: cannot open {path!r} mode={mode!r}")
        self._mode = mode

    def append(self, actions, rewards, extras=None) -> None:
        actions = np.ascontiguousarray(actions, dtype=np.float32)
        rewards = np.ascontiguousarray(rewards, dtype=np.float32)
        T, A = actions.shape
        if rewards.shape != (T,):
            raise ValueError(f"rewards shape {rewards.shape} != ({T},)")
        if extras is not None:
            extras = np.ascontiguousarray(extras, dtype=np.float32)
            E, eptr = extras.shape[1], _fptr(extras)
        else:
            E, eptr = 0, None
        rc = self._lib.ts_append(self._h, _fptr(actions), _fptr(rewards), eptr, T, A, E)
        if rc != 0:
            raise OSError("traj_store: append failed (read-only handle?)")

    def flush(self) -> None:
        self._lib.ts_flush(self._h)

    def __len__(self) -> int:
        # a writer's index materializes on close: count what was written
        return max(self._lib.ts_count(self._h), 0)

    def read(self, idx: int):
        info = (ctypes.c_uint32 * 3)()
        if self._lib.ts_record_info(self._h, idx, info) != 0:
            raise IndexError(idx)
        T, A, E = info[0], info[1], info[2]
        actions = np.empty((T, A), np.float32)
        rewards = np.empty((T,), np.float32)
        extras = np.empty((T, E), np.float32)
        rc = self._lib.ts_read(
            self._h, idx, _fptr(actions), _fptr(rewards), _fptr(extras) if E else None
        )
        if rc != 0:
            raise OSError(f"traj_store: read {idx} failed")
        return actions, rewards, extras

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ts_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
