"""ctypes bindings for the native k-mer count store (kmer_store.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from mini_parallel.native import _ensure_built

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _ensure_built("libkmerstore.so")
    if path is None:
        raise RuntimeError("libkmerstore.so not built")
    lib = ctypes.CDLL(path)
    lib.ks_new.restype = ctypes.c_void_p
    lib.ks_new.argtypes = [ctypes.c_uint64]
    lib.ks_free.argtypes = [ctypes.c_void_p]
    lib.ks_merge.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.ks_size.restype = ctypes.c_uint64
    lib.ks_size.argtypes = [ctypes.c_void_p]
    lib.ks_total.restype = ctypes.c_uint64
    lib.ks_total.argtypes = [ctypes.c_void_p]
    lib.ks_get.restype = ctypes.c_uint64
    lib.ks_get.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.ks_dump.restype = ctypes.c_uint64
    lib.ks_dump.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
    ]
    # ks_decode_planes is newer than the store ABI: a stale pre-rebuild .so
    # (kept deliberately when make fails, native/__init__.py) must still
    # serve the KmerStore path — decode_planes_native raises and its caller
    # (_decode_planes) falls back to the NumPy decoder.
    if hasattr(lib, "ks_decode_planes"):
        lib.ks_decode_planes.restype = None
        lib.ks_decode_planes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
    _lib = lib
    return lib


def decode_planes_native(planes: np.ndarray, m: int, kp: int, cp: int,
                         key0_biased: int, s: int):
    """One-pass native decode of drain byte planes (ops/kmer.py pack
    contract); -> (hi int32, lo int32, ct int64). Raises if the native lib
    is unavailable — callers fall back to the NumPy decoder."""
    lib = _load()
    planes = np.ascontiguousarray(planes, np.uint8)
    b = planes.size // (kp + cp)
    hi = np.empty(m, np.int32)
    lo = np.empty(m, np.int32)
    ct = np.empty(m, np.int64)
    lib.ks_decode_planes(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, m, kp, cp,
        ctypes.c_uint64(key0_biased & ((1 << 64) - 1)), s,
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ct.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return hi, lo, ct


class KmerStore:
    """Flat linear-probing (key -> count) aggregator in native memory."""

    def __init__(self, initial_capacity: int = 1 << 16):
        self._lib = _load()
        self._h = self._lib.ks_new(initial_capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ks_free(self._h)
            self._h = None

    def merge(self, key_hi: np.ndarray, key_lo: np.ndarray, counts: np.ndarray) -> None:
        key_hi = np.ascontiguousarray(key_hi, np.int32)
        key_lo = np.ascontiguousarray(key_lo, np.int32)
        counts = np.ascontiguousarray(counts, np.int32)
        self._lib.ks_merge(
            self._h,
            key_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            key_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            key_hi.size,
        )

    def __len__(self) -> int:
        return int(self._lib.ks_size(self._h))

    def total(self) -> int:
        return int(self._lib.ks_total(self._h))

    def get(self, hi: int, lo: int) -> int:
        return int(self._lib.ks_get(self._h, hi, lo))

    def items_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dump the store as (hi, lo, counts) NumPy arrays (no Python dict:
        a 26M-entry dict costs minutes; this is one C++ pass)."""
        n = len(self)
        hi = np.empty(n, np.int32)
        lo = np.empty(n, np.int32)
        ct = np.empty(n, np.uint64)
        w = self._lib.ks_dump(
            self._h,
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ct.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n,
        )
        w = int(w)
        return hi[:w], lo[:w], ct[:w]

    def items(self) -> dict:
        n = len(self)
        hi = np.empty(n, np.int32)
        lo = np.empty(n, np.int32)
        ct = np.empty(n, np.uint64)
        w = self._lib.ks_dump(
            self._h,
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ct.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n,
        )
        return {
            (int(hi[i]), int(lo[i])): int(ct[i]) for i in range(int(w))
        }
