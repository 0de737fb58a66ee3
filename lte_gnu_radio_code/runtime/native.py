"""ctypes bindings for the native host-side streaming runtime
(native/ringbuf.cc): SPSC ring buffer + chunked stream scheduler.

Load order: (1) the `_ringbuf` extension built by setup.py (installed
packages), (2) a cached g++ build from the source tree (dev checkouts; the
toolchain is part of the environment; pybind11 is not, hence ctypes).  See
native/ringbuf.cc for the role this plays vs the reference's GNU Radio C++
runtime.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
_NATIVE_DIR = _PKG_DIR.parent / "native"
_SO = _NATIVE_DIR / "libofdm_ring.so"
_SRC = _NATIVE_DIR / "ringbuf.cc"

_lib = None


def _build() -> None:
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-o", str(_SO), str(_SRC),
         "-lpthread"],
        check=True, capture_output=True)


def _locate() -> pathlib.Path:
    # installed-package extension (built by setup.py)
    hits = sorted(_PKG_DIR.glob("_ringbuf*.so"))
    if hits:
        return hits[0]
    if not _SRC.exists():
        raise FileNotFoundError(
            "native ring buffer: neither the packaged _ringbuf extension nor "
            f"the source tree ({_SRC}) is available")
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    return _SO


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_locate()))
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_capacity.restype = ctypes.c_size_t
    lib.ring_capacity.argtypes = [ctypes.c_void_p]
    for f in ("ring_available", "ring_space"):
        getattr(lib, f).restype = ctypes.c_size_t
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    for f in ("ring_write", "ring_read", "ring_peek"):
        getattr(lib, f).restype = ctypes.c_size_t
        getattr(lib, f).argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_size_t]
    lib.chunker_create.restype = ctypes.c_void_p
    lib.chunker_create.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_size_t]
    lib.chunker_destroy.argtypes = [ctypes.c_void_p]
    lib.chunker_pump.restype = ctypes.c_int
    lib.chunker_pump.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.chunker_staged.restype = ctypes.c_size_t
    lib.chunker_staged.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """complex64 SPSC ring buffer (GNU Radio circular-buffer analog)."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self._h = self._lib.ring_create(capacity)
        if not self._h:
            raise MemoryError("ring_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._h)

    @property
    def available(self) -> int:
        return self._lib.ring_available(self._h)

    @property
    def space(self) -> int:
        return self._lib.ring_space(self._h)

    def write(self, samples: np.ndarray) -> int:
        x = np.ascontiguousarray(samples, dtype=np.complex64)
        return self._lib.ring_write(self._h, _fp(x.view(np.float32)), x.size)

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.complex64)
        got = self._lib.ring_read(self._h, _fp(out.view(np.float32)), n)
        return out[:got]

    def peek(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.complex64)
        got = self._lib.ring_peek(self._h, _fp(out.view(np.float32)), n)
        return out[:got]


class NativeChunker:
    """Work-quantum chunker with leftover carry (OFDMTransmitter.py:92-102
    semantics): assembles fixed-size device batches from a ring."""

    def __init__(self, ring: NativeRing, chunk: int, max_quantum: int = 4095):
        self._lib = load_library()
        self._ring = ring                 # keep alive
        self.chunk = chunk
        self._h = self._lib.chunker_create(ring._h, chunk, max_quantum)
        if not self._h:
            raise MemoryError("chunker_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chunker_destroy(self._h)
            self._h = None

    @property
    def staged(self) -> int:
        return self._lib.chunker_staged(self._h)

    def pump(self) -> np.ndarray | None:
        out = np.empty(self.chunk, dtype=np.complex64)
        if self._lib.chunker_pump(self._h, _fp(out.view(np.float32))):
            return out
        return None
