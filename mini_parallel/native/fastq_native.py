"""ctypes bindings for the native FASTQ decoder (fastq_reader.cpp)."""

from __future__ import annotations

import ctypes
from typing import Iterator

import numpy as np

from mini_parallel.native import _ensure_built


class NativeUnavailable(RuntimeError):
    pass


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _ensure_built("libfastq.so")
    if path is None:
        raise NativeUnavailable("libfastq.so not built (no C++ toolchain?)")
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:  # wrong arch / missing deps: a LOADER error, not
        # file I/O — must surface as NativeUnavailable so callers fall back
        # to the Python decoder instead of aborting the read
        raise NativeUnavailable(f"cannot load {path}: {e}") from e
    lib.fq_open.restype = ctypes.c_void_p
    lib.fq_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fq_next_chunk.restype = ctypes.c_int64
    lib.fq_next_chunk.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    # quals symbols may be absent from a stale prebuilt .so: degrade only
    # the quals feature, keep the sequence-only fast path native
    if getattr(lib, "fq_open_q", None) is not None:
        lib.fq_open_q.restype = ctypes.c_void_p
        lib.fq_open_q.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int32]
        lib.fq_next_chunk_q.restype = ctypes.c_int64
        lib.fq_next_chunk_q.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._has_quals = True
    else:
        lib._has_quals = False
    lib.fq_error.restype = ctypes.c_char_p
    lib.fq_error.argtypes = [ctypes.c_void_p]
    lib.fq_total_reads.restype = ctypes.c_int64
    lib.fq_total_reads.argtypes = [ctypes.c_void_p]
    lib.fq_line_count.restype = ctypes.c_int64
    lib.fq_line_count.argtypes = [ctypes.c_void_p]
    # error-tolerance counter may be absent from a stale prebuilt .so
    if getattr(lib, "fq_error_count", None) is not None:
        lib.fq_error_count.restype = ctypes.c_int64
        lib.fq_error_count.argtypes = [ctypes.c_void_p]
    lib.fq_close.argtypes = [ctypes.c_void_p]
    lib.fq_count_lines.restype = ctypes.c_int64
    lib.fq_count_lines.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


def count_lines_native(path: str) -> int:
    lib = _load()
    n = lib.fq_count_lines(path.encode())
    if n < 0:
        raise IOError(f"native line count failed for {path}")
    return int(n)


def iter_read_chunks_native(
    path: str, chunk_size_reads: int, avg_read_len_hint: int = 256
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (bytes, offsets) flat chunks: read i = bytes[offsets[i]:offsets[i+1]].

    The gzip decode + record parse runs in a background C++ thread with one
    chunk of readahead, overlapping host decode with device compute.
    """
    lib = _load()
    h = lib.fq_open(path.encode(), chunk_size_reads)
    if not h:
        raise IOError(f"cannot open {path}")
    bytes_cap = max(chunk_size_reads * avg_read_len_hint, 1 << 20)
    try:
        buf = np.empty(bytes_cap, np.uint8)
        offs = np.empty(chunk_size_reads + 2, np.int64)
        need_b = ctypes.c_int64()
        need_r = ctypes.c_int64()
        while True:
            n = lib.fq_next_chunk(
                h,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), offs.size,
                ctypes.byref(need_b), ctypes.byref(need_r),
            )
            if n == 0:
                return
            if n == -1:
                raise IOError(
                    f"Error reading {path}: {lib.fq_error(h).decode(errors='replace')}"
                )
            if n == -2:  # grow buffers and retry
                buf = np.empty(max(need_b.value, buf.size * 2), np.uint8)
                offs = np.empty(max(need_r.value + 2, offs.size * 2), np.int64)
                continue
            n = int(n)
            yield buf[: offs[n]].copy(), offs[: n + 1].copy()
    finally:
        lib.fq_close(h)


def iter_reads_native(path: str, chunk_size_reads: int) -> Iterator[list[bytes]]:
    """Chunked read lists (drop-in for io.fastq.iter_read_chunks)."""
    for flat, offs in iter_read_chunks_native(path, chunk_size_reads):
        data = flat.tobytes()
        yield [data[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)]


def iter_flat_with_quals_native(
    path: str, chunk_size_reads: int, avg_read_len_hint: int = 256
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(seq_flat, seq_offs, qual_flat, qual_offs) chunks — the quals-aware
    counterpart of iter_read_chunks_native (no per-read Python objects;
    records complete at their quality line; a truncated final record gets
    an empty qual)."""
    lib = _load()
    if not getattr(lib, "_has_quals", False):
        raise NativeUnavailable("libfastq.so predates the quals ABI; "
                                "rebuild (make -C mini_parallel/native)")
    h = lib.fq_open_q(path.encode(), chunk_size_reads, 1)
    if not h:
        raise IOError(f"cannot open {path}")
    bytes_cap = max(chunk_size_reads * avg_read_len_hint, 1 << 20)
    try:
        buf = np.empty(bytes_cap, np.uint8)
        qbuf = np.empty(bytes_cap, np.uint8)
        offs = np.empty(chunk_size_reads + 2, np.int64)
        qoffs = np.empty(chunk_size_reads + 2, np.int64)
        need_b = ctypes.c_int64()
        need_r = ctypes.c_int64()
        need_q = ctypes.c_int64()
        while True:
            n = lib.fq_next_chunk_q(
                h,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), offs.size,
                qbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), qbuf.size,
                qoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), qoffs.size,
                ctypes.byref(need_b), ctypes.byref(need_r),
                ctypes.byref(need_q),
            )
            if n == 0:
                return
            if n == -1:
                raise IOError(
                    f"Error reading {path}: "
                    f"{lib.fq_error(h).decode(errors='replace')}"
                )
            if n == -2:  # grow buffers and retry
                buf = np.empty(max(need_b.value, buf.size * 2), np.uint8)
                qbuf = np.empty(max(need_q.value, qbuf.size * 2), np.uint8)
                offs = np.empty(max(need_r.value + 2, offs.size * 2), np.int64)
                qoffs = np.empty(offs.size, np.int64)
                continue
            n = int(n)
            yield (buf[: offs[n]].copy(), offs[: n + 1].copy(),
                   qbuf[: qoffs[n]].copy(), qoffs[: n + 1].copy())
    finally:
        lib.fq_close(h)


def iter_reads_with_quals_native(
    path: str, chunk_size_reads: int, avg_read_len_hint: int = 256
) -> Iterator[tuple[list[bytes], list[bytes]]]:
    """(sequences, quality_strings) list chunks (wrapper over the flat
    iterator for callers that want Python bytes)."""
    for flat, offs, qflat, qoffs in iter_flat_with_quals_native(
        path, chunk_size_reads, avg_read_len_hint
    ):
        data = flat.tobytes()
        qdata = qflat.tobytes()
        n = len(offs) - 1
        yield (
            [data[offs[i]: offs[i + 1]] for i in range(n)],
            [qdata[qoffs[i]: qoffs[i + 1]] for i in range(n)],
        )
