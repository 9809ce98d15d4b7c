"""The host-side PCD reader in C++ (the port's copy of
sparenet_tpu/native: ``pcloud.cc`` and its ctypes binding).

``read_pcd_native(path)`` -> [N, 3] float32 x/y/z of an uncompressed
.pcd file (ASCII or binary). The library is built with ``g++`` at first use
into ``sparenet_tpu_torch/_build/`` (listed in .gitignore), under a name that
hashes the source, to a temporary name of the building process that is
renamed into place, so concurrent builds (parallel test workers) need no
lock. A build failure raises with the compiler's message, and a file the
reader cannot parse raises ``ValueError``: there is no fall-back to the
Python codec (``data/io.py:read_pcd``, which the tests hold this reader to).
The binary path gives 0.0 for integer-typed x/y/z fields, as the JAX
package's reader does (ROADMAP.md §3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "build", "lib", "read_pcd_native"]

SOURCE = Path(__file__).resolve().parent / "pcloud.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_TIMEOUT_S = 300

_lock = threading.Lock()
_LIB = None


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpcloud_{digest}.so"


def build() -> Path:
    """Compile the library if this source has none yet; its path. Raises
    ``RuntimeError`` with the compiler's output if g++ fails."""
    path = _library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
           "-o", str(tmp)]
    try:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=GXX_TIMEOUT_S)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the PCD reader "
                               f"({SOURCE.name}) cannot be built") from e
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed with code {r.returncode}: "
                               f"{' '.join(cmd)}\n{r.stdout[-2000:]}"
                               f"{r.stderr[-6000:]}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _LIB
    with _lock:
        if _LIB is None:
            so = ctypes.CDLL(str(build()))
            so.pcd_read.restype = ctypes.c_int64
            so.pcd_read.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
            so.pcd_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            so.pcd_free.restype = None
            _LIB = so
    return _LIB


def read_pcd_native(path: str) -> np.ndarray:
    """[N, 3] float32 x/y/z of the .pcd file ``path``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such .pcd file: {path}")
    so = lib()
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = so.pcd_read(os.fsencode(path), ctypes.byref(ptr))
    if n < 0:
        raise ValueError(f"{path}: not a .pcd file the reader can parse "
                         f"(uncompressed ASCII or binary with x, y and z "
                         f"fields)")
    try:
        return np.ctypeslib.as_array(ptr, shape=(int(n), 3)).copy() if n else \
            np.zeros((0, 3), np.float32)
    finally:
        so.pcd_free(ptr)
