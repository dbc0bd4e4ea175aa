"""2-bit packed host->device transfer for read batches.

The reference ships raw ASCII bytes to the device (`smith_waterman/src/
aligner.rs:478-499` builds byte buffers from ``seq.as_bytes()``) — 8 bits per
base over the PCIe wire. Since DNA is a 4-letter alphabet, the new
framework packs 4 bases/byte on the host and unpacks on-device with cheap
elementwise shifts/selects, cutting host->device bytes 4x. Alignment pipelines are
typically transfer-bound (the reference's own postmortem flags memory
bandwidth, `improvements.txt:38-40`), so this directly multiplies end-to-end
reads/s.

Bit-exactness contract: unpack reproduces the original padded uint8 batch
EXACTLY. Rare non-ACGT bytes (N calls, lowercase, IUPAC codes) are carried in
a per-row exception list (column, original byte) applied as a scatter after
unpack; positions past each row's length are refilled from the pad sentinel.
So parity-mode (byte-equality) scores are unchanged, not approximated.

Layout: exceptions are (B, K) with K bucketed to a power of two, column ==
L marking an empty slot (out-of-bounds, dropped by the scatter). Keeping
them per-row (not flat) lets the arrays shard on the batch axis alongside
the reads in shard_map pipelines.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# 2-bit codes for the packable alphabet (uppercase ACGT only: anything else
# must round-trip byte-exactly through the exception list).
_PACK_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _PACK_CODE[_ch] = _i
_A, _C, _G, _T = (np.uint8(c) for c in b"ACGT")

MIN_EXC_BUCKET = 1


@dataclasses.dataclass
class PackedBatch:
    """Host-side packed representation of a (B, L) uint8 read batch."""

    packed: np.ndarray  # (B, L // 4) uint8, 4 bases per byte, LSB-first
    exc_col: np.ndarray  # (B, K) int32, column of each non-ACGT byte; L = empty
    exc_val: np.ndarray  # (B, K) uint8, the original byte
    lengths: np.ndarray  # (B,) int32 valid prefix per row
    length: int  # L (static row width; multiple of 4)

    @property
    def batch(self) -> int:
        return self.packed.shape[0]

    def wire_bytes(self) -> int:
        return (
            self.packed.nbytes + self.exc_col.nbytes + self.exc_val.nbytes
            + self.lengths.nbytes
        )


def _exc_bucket(n: int) -> int:
    b = MIN_EXC_BUCKET
    while b < n:
        b <<= 1
    return b


_native_lib = None
_native_failed = False


def _native():
    """ctypes handle to libpack2bit.so, or None (pure-NumPy fallback)."""
    global _native_lib, _native_failed
    if _native_lib is not None or _native_failed:
        return _native_lib
    try:
        import ctypes

        from mini_parallel.native import _ensure_built

        path = _ensure_built("libpack2bit.so")
        if path is None:
            raise RuntimeError("libpack2bit.so not built")
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.p2_pack.restype = ctypes.c_int64
        lib.p2_pack.argtypes = [u8p, i32p, ctypes.c_int64, ctypes.c_int64,
                                u8p, i32p]
        lib.p2_fill_exceptions.restype = None
        lib.p2_fill_exceptions.argtypes = [u8p, i32p, i32p, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int64,
                                           i32p, u8p]
        _native_lib = lib
    except Exception:  # noqa: BLE001 — any failure means use NumPy
        _native_failed = True
    return _native_lib


def _pack_batch_native(arr: np.ndarray, lengths: np.ndarray,
                       lib) -> PackedBatch:
    import ctypes

    B, L = arr.shape
    arr = np.ascontiguousarray(arr)
    lengths = np.ascontiguousarray(lengths, np.int32)
    packed = np.empty((B, L // 4), np.uint8)
    exc_counts = np.empty(B, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    max_exc = lib.p2_pack(
        arr.ctypes.data_as(u8p), lengths.ctypes.data_as(i32p), B, L,
        packed.ctypes.data_as(u8p), exc_counts.ctypes.data_as(i32p),
    )
    K = _exc_bucket(int(max_exc))
    exc_col = np.full((B, K), L, np.int32)
    exc_val = np.zeros((B, K), np.uint8)
    if max_exc:
        lib.p2_fill_exceptions(
            arr.ctypes.data_as(u8p), lengths.ctypes.data_as(i32p),
            exc_counts.ctypes.data_as(i32p), B, L, K,
            exc_col.ctypes.data_as(i32p), exc_val.ctypes.data_as(u8p),
        )
    return PackedBatch(packed=packed, exc_col=exc_col, exc_val=exc_val,
                       lengths=lengths, length=L)


def pack_batch(arr: np.ndarray, lengths: np.ndarray) -> PackedBatch:
    """Pack a padded (B, L) uint8 batch (L % 4 == 0) into 2-bit + exceptions.

    ``arr`` rows must be valid bytes for the first ``lengths[i]`` columns; the
    remainder is pad (reconstructed from the pad sentinel at unpack time, so
    pad bytes never cost exceptions). Uses the native single-pass packer
    (native/pack2bit.cpp) when built; NumPy otherwise.
    """
    B, L = arr.shape
    if L % 4 != 0:
        raise ValueError(f"row width {L} not a multiple of 4")
    lengths = np.asarray(lengths, np.int32)
    lib = _native()
    if lib is not None:
        return _pack_batch_native(arr, lengths, lib)
    codes = _PACK_CODE[arr]
    valid = np.arange(L, dtype=np.int32)[None, :] < lengths[:, None]
    bad = (codes == 255) & valid
    codes = np.where(codes == 255, 0, codes)
    packed = (
        codes[:, 0::4]
        | (codes[:, 1::4] << 2)
        | (codes[:, 2::4] << 4)
        | (codes[:, 3::4] << 6)
    ).astype(np.uint8)

    rows, cols = np.nonzero(bad)
    if rows.size:
        per_row = np.bincount(rows, minlength=B)
        K = _exc_bucket(int(per_row.max()))
        # slot index within the row: position among this row's exceptions
        # (np.nonzero is row-major, so each row's hits are contiguous)
        slot = np.arange(rows.size) - np.searchsorted(rows, rows)
        exc_col = np.full((B, K), L, np.int32)
        exc_val = np.zeros((B, K), np.uint8)
        exc_col[rows, slot] = cols.astype(np.int32)
        exc_val[rows, slot] = arr[rows, cols]
    else:
        K = MIN_EXC_BUCKET
        exc_col = np.full((B, K), L, np.int32)
        exc_val = np.zeros((B, K), np.uint8)
    return PackedBatch(packed=packed, exc_col=exc_col, exc_val=exc_val,
                       lengths=lengths, length=L)


def pad_rows(pb: PackedBatch, rows: int) -> PackedBatch:
    """Pad the batch to ``rows`` with empty (length-0) entries."""
    B = pb.batch
    if rows == B:
        return pb
    if rows < B:
        raise ValueError(f"cannot shrink batch {B} -> {rows}")
    add = rows - B
    return PackedBatch(
        packed=np.concatenate([pb.packed, np.zeros((add, pb.packed.shape[1]), np.uint8)]),
        exc_col=np.concatenate([pb.exc_col, np.full((add, pb.exc_col.shape[1]), pb.length, np.int32)]),
        exc_val=np.concatenate([pb.exc_val, np.zeros((add, pb.exc_val.shape[1]), np.uint8)]),
        lengths=np.concatenate([pb.lengths, np.zeros(add, np.int32)]),
        length=pb.length,
    )


def unpack_device(packed: jnp.ndarray, exc_col: jnp.ndarray,
                  exc_val: jnp.ndarray, lengths: jnp.ndarray,
                  pad_value: int) -> jnp.ndarray:
    """Device-side inverse of pack_batch: -> (B, L) uint8, pad-filled.

    Pure elementwise work (shifts + 3 selects) plus one small scatter for
    the exceptions; XLA fuses the unpack into the consuming kernel's input
    read. Runs under shard_map with everything sharded on the batch axis.
    """
    B, L4 = packed.shape
    L = L4 * 4
    shifts = jnp.array([0, 2, 4, 6], jnp.int32)
    c = (packed[:, :, None].astype(jnp.int32) >> shifts[None, None, :]) & 3
    c = c.reshape(B, L)
    ascii_ = jnp.where(
        c == 0, _A, jnp.where(c == 1, _C, jnp.where(c == 2, _G, _T))
    ).astype(jnp.uint8)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    ascii_ = ascii_.at[rows, exc_col].set(exc_val, mode="drop")
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(pos < lengths[:, None], ascii_, jnp.uint8(pad_value))


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """(B, L) bool -> (B, ceil(L/8)) uint8, LSB-first (8x fewer wire bytes).

    Used for per-base boolean side-channels (e.g. base-quality pass masks)
    that ride along with 2-bit packed reads.
    """
    return np.packbits(mask, axis=1, bitorder="little")


def unpack_bits_device(packed_bits: jnp.ndarray, L: int) -> jnp.ndarray:
    """Device-side inverse of pack_bits: -> (B, L) bool."""
    B, L8 = packed_bits.shape
    shifts = jnp.arange(8, dtype=jnp.int32)
    bits = (packed_bits[:, :, None].astype(jnp.int32) >> shifts[None, None, :]) & 1
    return bits.reshape(B, L8 * 8)[:, :L].astype(bool)


def device_args(pb: PackedBatch):
    """The jit-traceable argument tuple for unpack_device (order matters)."""
    return (
        jnp.asarray(pb.packed),
        jnp.asarray(pb.exc_col),
        jnp.asarray(pb.exc_val),
        jnp.asarray(pb.lengths),
    )


def put_sharded(pb: PackedBatch, mesh, axis: str | None = None):
    """device_args with every array placed on ``mesh``, batch axis sharded.

    The one shared sharding recipe for PackedBatch operands (rows on the
    data axis, everything else replicated along it)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = axis or mesh.axis_names[0]
    out = []
    for a in device_args(pb):
        spec = P(axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
