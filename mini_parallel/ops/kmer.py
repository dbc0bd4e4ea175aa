"""k-mer counting: 2-bit packing, device-side sort/dedup, exact counts.

The reference *advertises* k-mer counting (`README.md:2`) but ships only a
placeholder (`k_mer/kmer.txt:1` = "filler"); BASELINE.json config 3 requires
k=21 counting with exact parity. This is the real implementation, on the
device:

- bases 2-bit packed (A=0 C=1 G=2 T=3); a k=21-mer needs 42 bits, split into
  (hi, lo) int32 halves since JAX runs with 64-bit integers off by
  default. Windows
  containing N (or crossing a read's end) are masked out.
- all windows of a read batch are packed with k static shifted adds (XLA
  fuses the whole thing into a few vector ops),
- exact per-batch counting = lexicographic sort of (hi, lo) via lax.sort +
  run-length encoding into fixed-size (keys, counts) arrays — the
  "sorted-hash reduction in HBM" the north star asks for,
- cross-chunk / cross-shard merging happens on host (Python dict here; the
  C++ kmer store in native/ is the fast path) or via psum of bucketed
  histograms for the sharded pipeline stats.

Canonical mode folds each k-mer with its reverse complement (min of the two
encodings), the standard convention for strand-neutral counting.
"""

from __future__ import annotations

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np

from mini_parallel.ops import encode

DEFAULT_K = 21
# sentinel sort key for invalid windows: sorts after every real (hi, lo)
_SENTINEL = np.int32(2**31 - 1)
# below this distinct-key count the compressed drain's extra dispatches cost
# more than the saved wire bytes (tests patch it to 0)
COMPRESS_MIN_KEYS = 1 << 16


def pack_kmers(
    codes: jnp.ndarray, lengths: jnp.ndarray, k: int = DEFAULT_K,
    canonical: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack every length-k window of a (B, L) code batch.

    Returns (hi, lo, valid), each (B, W) with W = L - k + 1.
    hi holds the first ceil(k/2) bases (2 bits each), lo the rest; a window is
    valid iff it lies within the read's true length and contains no N.
    """
    B, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read pad {L} shorter than k={k}")
    if not 1 <= k <= 31:
        # k=32 fills BOTH int32 halves: the all-T k-mer packs to (-1, -1),
        # colliding with the run-detection init and losing its count; k>32
        # overflows the hi word and aliases distinct k-mers. The native
        # store documents the same bound (kmer_store.cpp: "k <= 31").
        raise ValueError(f"k={k} out of range: 2-bit packed keys support "
                         f"1 <= k <= 31")
    c = codes.astype(jnp.int32)
    k_hi = (k + 1) // 2  # bases in the hi word (<= 16 -> <= 32 bits)

    hi = jnp.zeros((B, W), jnp.int32)
    lo = jnp.zeros((B, W), jnp.int32)
    ok = jnp.ones((B, W), dtype=bool)
    for i in range(k):
        ci = jax.lax.dynamic_slice_in_dim(c, i, W, axis=1)
        ok = ok & (ci <= 3)  # N/pad codes are > 3
        if i < k_hi:
            hi = hi * 4 + jnp.where(ci <= 3, ci, 0)
        else:
            lo = lo * 4 + jnp.where(ci <= 3, ci, 0)
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    ok = ok & (pos + k <= lengths[:, None])

    if canonical:
        rc_hi, rc_lo = _revcomp_key(c, k, W)
        fwd_smaller = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
        hi = jnp.where(fwd_smaller, hi, rc_hi)
        lo = jnp.where(fwd_smaller, lo, rc_lo)
    return hi, lo, ok


def _revcomp_key(c: jnp.ndarray, k: int, W: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(hi, lo) of the reverse-complement of each window."""
    k_hi = (k + 1) // 2
    comp = jnp.where(c <= 3, 3 - c, c)  # A<->T, C<->G in code space
    hi = jnp.zeros(c.shape[:1] + (W,), jnp.int32)
    lo = jnp.zeros_like(hi)
    # reverse complement reads window positions k-1 .. 0
    for j, i in enumerate(range(k - 1, -1, -1)):
        ci = jax.lax.dynamic_slice_in_dim(comp, i, W, axis=1)
        ci = jnp.where(ci <= 3, ci, 0)
        if j < k_hi:
            hi = hi * 4 + ci
        else:
            lo = lo * 4 + ci
    return hi, lo


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def unique_counts_batch(
    codes: jnp.ndarray, lengths: jnp.ndarray, k: int = DEFAULT_K,
    canonical: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Device-exact k-mer counting for one read batch.

    Returns (keys_hi, keys_lo, counts, n_unique): flat arrays of length B*W,
    sorted by key with runs collapsed — all unique keys live in positions
    [0, n_unique), so callers need only fetch that prefix off-device —
    plus the scalar unique count.
    """
    hi, lo, ok = pack_kmers(codes, lengths, k, canonical)
    n = hi.size
    hi = jnp.where(ok, hi, _SENTINEL).reshape(n)
    lo = jnp.where(ok, lo, _SENTINEL).reshape(n)
    okf = ok.reshape(n)

    hi_s, lo_s, ok_s = jax.lax.sort((hi, lo, okf), num_keys=2)
    return _rle_compact(hi_s, lo_s, ok_s.astype(jnp.int32), ok_s)


def _rle_compact(hi_s, lo_s, weights, valid):
    """Collapse runs of equal (hi, lo) keys in SORTED key arrays.

    -> (key_hi, key_lo, counts, n_unique): unique keys compacted to the
    front (invalid tail = _SENTINEL keys, zero counts); counts[i] sums the
    ``weights`` of run i. The single source of truth for the sort-free part
    of the sorted-dedup used by unique_counts_batch AND _sorted_merge.

    SCATTER-FREE (round-3 rewrite — the previous version was the measured
    k-mer drain wall): run totals come from segmented sums built out of
    cumsum + running-max (two optimized cumulative primitives, no
    scatters — a tuple-carry associative_scan compiled pathologically
    at 33.5M), each
    run's END slot becomes its representative carrying the total, and one
    stable 2-key lax.sort compacts representatives to the front (reps are
    already in key order; non-reps carry SENTINEL keys and 0 counts, so
    they form the tail). A 3-scatter compaction (at[].set / segment_sum)
    measured far slower than the sort on the accelerator this was first
    built for; this one rides the sort. Not yet re-measured on the GPU."""
    is_start, is_end = _run_edges(hi_s, lo_s, valid)
    w = jnp.where(valid, weights, 0).astype(jnp.int32)

    # Segmented sums via two cumulative primitives (cheaper to compile and
    # run than a tuple-carry associative_scan at 33.5M): C = cumsum(w);
    # each start slot samples C just before its run; the running MAX
    # propagates that base through the run (valid because C is
    # nondecreasing, so later starts always carry a >= base); run total at
    # the end slot = C[end] - base. int32-safe: total weight is bounded by
    # the accumulator's _INT32_SAFE spill discipline (and by n for the 0/1
    # weights of unique_counts_batch).
    C = jnp.cumsum(w)
    prevC = jnp.concatenate([jnp.zeros((1,), jnp.int32), C[:-1]])
    base = jax.lax.cummax(jnp.where(is_start, prevC, -1))
    seg_total = C - base
    rep_hi = jnp.where(is_end, hi_s, _SENTINEL)
    rep_lo = jnp.where(is_end, lo_s, _SENTINEL)
    rep_ct = jnp.where(is_end, seg_total, 0)
    key_hi, key_lo, counts = jax.lax.sort(
        (rep_hi, rep_lo, rep_ct), num_keys=2
    )
    n_unique = jnp.sum(is_start.astype(jnp.int32))
    return key_hi, key_lo, counts, n_unique


def _run_edges(hi_s, lo_s, valid):
    """(is_start, is_end) masks of key runs in sorted (hi, lo) arrays."""
    neg = jnp.full((1,), -1, jnp.int32)
    prev_hi = jnp.concatenate([neg, hi_s[:-1]])
    prev_lo = jnp.concatenate([neg, lo_s[:-1]])
    nxt_hi = jnp.concatenate([hi_s[1:], neg])
    nxt_lo = jnp.concatenate([lo_s[1:], neg])
    is_start = valid & ((hi_s != prev_hi) | (lo_s != prev_lo))
    is_end = valid & ((hi_s != nxt_hi) | (lo_s != nxt_lo))
    return is_start, is_end


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def unique_counts_packed(
    packed: jnp.ndarray, exc_col: jnp.ndarray, exc_val: jnp.ndarray,
    lengths: jnp.ndarray, k: int = DEFAULT_K, canonical: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """unique_counts_batch over a 2-bit packed wire batch (ops/packed.py).

    Reads cross host->device at 4 bases/byte; the unpack fuses into the
    window packing, so this is strictly cheaper than shipping ASCII.
    """
    from mini_parallel.ops import packed as packedmod

    ascii_ = packedmod.unpack_device(
        packed, exc_col, exc_val, lengths, int(encode.PAD_A)
    )
    codes = encode.ascii_to_code(ascii_)
    return unique_counts_batch(codes, lengths, k=k, canonical=canonical)


# ---------------------------------------------------------------------------
# Device-resident accumulator: the aggregate (keys, counts) lives in HBM
# across batches — the literal "sorted-hash reduction in HBM". Batches
# append their compacted uniques into a staging region; when it fills, one
# sorted merge folds staging into the store. Device->host traffic is ZERO
# until the final drain (the host-store path fetches every batch's uniques).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _staging_append(st_hi, st_lo, st_ct, off, hi, lo, ct):
    return (
        jax.lax.dynamic_update_slice(st_hi, hi, (off,)),
        jax.lax.dynamic_update_slice(st_lo, lo, (off,)),
        jax.lax.dynamic_update_slice(st_ct, ct, (off,)),
    )


@jax.jit  # no donation: output shapes differ from every input's
def _sorted_merge(hi_a, lo_a, ct_a, hi_b, lo_b, ct_b):
    """Fold two (key -> count) slabs into one sorted, RLE-combined slab.

    Inputs may contain duplicate keys (ct > 0) and SENTINEL padding
    (ct == 0). Returns (hi, lo, ct, n_unique) of length len(a) + len(b),
    uniques compacted to the front.

    This IS the default fold: a 2-key lax.sort. The rank merge below
    exploits the inputs being pre-sorted, but its chained gather rounds
    measured orders of magnitude slower on the accelerator this was first
    built for; it is kept behind MPT_KMER_RANK_FOLD as a negative result
    (not yet re-measured on the GPU).
    """
    hi = jnp.concatenate([hi_a, hi_b])
    lo = jnp.concatenate([lo_a, lo_b])
    ct = jnp.concatenate([ct_a, ct_b])
    hi, lo, ct = jax.lax.sort((hi, lo, ct), num_keys=2)
    return _rle_compact(hi, lo, ct, ct > 0)


# ---------------------------------------------------------------------------
# Rank merge: sorted runs are merged with a vectorized binary search instead
# of lax.sort. For each element its merged position = own index + rank in
# the other run (searchsorted 'left' for run a, 'right' for run b, so ties
# interleave a-first into a permutation) — one scatter materializes the
# merge. Work per two-way merge is O(n log n) GATHER-light compares vs the
# comparison sort's full resort; keys stay int32 (hi, lo) pairs under the
# same signed lexicographic order lax.sort used (any consistent total order
# works for RLE; SENTINEL pairs remain maximal since lo < 2^30 for k <= 31).
#
# NEGATIVE RESULT (measured on the accelerator this was first built for;
# don't re-default without GPU numbers): the vectorized binary search issues
# log2(L)=24 data-dependent gather rounds, which ran about two orders of
# magnitude slower than the sort network's sequential-access passes.
# Enabled via MPT_KMER_RANK_FOLD.
# ---------------------------------------------------------------------------


def _pair_less(h1, l1, h2, l2):
    return (h1 < h2) | ((h1 == h2) & (l1 < l2))


def _pair_searchsorted_rows(hi_s, lo_s, hi_q, lo_q, side: str):
    """Row-batched binary search: ranks of (hi_q, lo_q)[r] within the
    sorted run (hi_s, lo_s)[r], for every row r. Fixed-trip count with a
    convergence guard (lo==hi rows stop updating)."""
    L = hi_s.shape[1]
    steps = max(1, L.bit_length())
    lo_i = jnp.zeros(hi_q.shape, jnp.int32)
    hi_i = jnp.full(hi_q.shape, L, jnp.int32)

    def body(_, c):
        lo_i, hi_i = c
        cont = lo_i < hi_i
        mid = (lo_i + hi_i) >> 1
        midc = jnp.minimum(mid, L - 1)
        mh = jnp.take_along_axis(hi_s, midc, axis=1)
        ml = jnp.take_along_axis(lo_s, midc, axis=1)
        if side == "left":
            go = _pair_less(mh, ml, hi_q, lo_q)  # s[mid] < q
        else:
            go = ~_pair_less(hi_q, lo_q, mh, ml)  # s[mid] <= q
        go = go & cont
        return (jnp.where(go, mid + 1, lo_i),
                jnp.where(cont & ~go, mid, hi_i))

    lo_i, hi_i = jax.lax.fori_loop(0, steps, body, (lo_i, hi_i))
    return lo_i


def _merge_level(hi, lo, ct):
    """One tree-merge level: (R, L) sorted runs -> (R//2, 2L)."""
    R, L = hi.shape
    ha, la, ca = hi[0::2], lo[0::2], ct[0::2]
    hb, lb, cb = hi[1::2], lo[1::2], ct[1::2]
    ia = _pair_searchsorted_rows(hb, lb, ha, la, "left")
    ib = _pair_searchsorted_rows(ha, la, hb, lb, "right")
    ar = jnp.arange(L, dtype=jnp.int32)[None, :]
    pa, pb = ia + ar, ib + ar
    rows = jnp.arange(R // 2, dtype=jnp.int32)[:, None]
    oh = jnp.full((R // 2, 2 * L), _SENTINEL, jnp.int32)
    oh = oh.at[rows, pa].set(ha).at[rows, pb].set(hb)
    ol = jnp.full((R // 2, 2 * L), _SENTINEL, jnp.int32)
    ol = ol.at[rows, pa].set(la).at[rows, pb].set(lb)
    oc = jnp.zeros((R // 2, 2 * L), jnp.int32)
    oc = oc.at[rows, pa].set(ca).at[rows, pb].set(cb)
    return oh, ol, oc


@jax.jit
def _rank_merge_runs(hi, lo, ct):
    """Merge R (power of two) sorted runs of length L -> one sorted run of
    R*L, duplicates preserved. log2(R) levels, each a vectorized two-way
    rank merge over all rows at once."""
    assert hi.shape[0] & (hi.shape[0] - 1) == 0, "run count must be 2^r"
    while hi.shape[0] > 1:
        hi, lo, ct = _merge_level(hi, lo, ct)
    return hi[0], lo[0], ct[0]


@jax.jit
def _rank_merge_pair(hi_a, lo_a, ct_a, hi_b, lo_b, ct_b):
    """Two-way rank merge of unequal-length SORTED slabs + RLE-combine:
    the drop-in fold replacing _sorted_merge's full re-sort. Same return
    contract: (hi, lo, ct, n_unique) of length len(a) + len(b)."""
    ha, la, ca = hi_a[None], lo_a[None], ct_a[None]
    hb, lb, cb = hi_b[None], lo_b[None], ct_b[None]
    ia = _pair_searchsorted_rows(hb, lb, ha, la, "left")[0]
    ib = _pair_searchsorted_rows(ha, la, hb, lb, "right")[0]
    n, m = hi_a.shape[0], hi_b.shape[0]
    pa = ia + jnp.arange(n, dtype=jnp.int32)
    pb = ib + jnp.arange(m, dtype=jnp.int32)
    oh = jnp.full((n + m,), _SENTINEL, jnp.int32)
    oh = oh.at[pa].set(hi_a).at[pb].set(hi_b)
    ol = jnp.full((n + m,), _SENTINEL, jnp.int32)
    ol = ol.at[pa].set(lo_a).at[pb].set(lo_b)
    oc = jnp.zeros((n + m,), jnp.int32)
    oc = oc.at[pa].set(ct_a).at[pb].set(ct_b)
    return _rle_compact(oh, ol, oc, oc > 0)


# ---------------------------------------------------------------------------
# Compressed drain: the final device->host fetch of the distinct-key store is
# the k-mer engine's wall on thin links (12 bytes/key raw). Keys leave the store SORTED, so consecutive deltas are
# small: encode each key as a 42..58-bit delta and ship only the byte planes
# that are anywhere non-zero (typically 3 of 8), plus count byte planes
# (typically 1 of 4) — ~3x fewer wire bytes, decoded host-side with one
# numpy cumsum. Pure jnp; plane counts are static args so the
# pack compiles once per (bucket, kp, cp) geometry.
# ---------------------------------------------------------------------------


_SIGN = 0x80000000  # int32-order <-> uint32-order bias (XOR)


@functools.partial(jax.jit, static_argnames=("s",))
def _delta_limbs(hi, lo, ct, s: int = 32):
    """Per-element key deltas in two uint32 limbs + validity mask.

    ``s`` is the true bit width of the lo word (2*(k//2) for pack_kmers
    keys): deltas are taken in the TIGHT key embedding key = hi·2^s + lo,
    not the limb embedding hi·2^32 + lo. This matters enormously for the
    wire: for k=21 the lo word holds only 20 bits, so in the limb
    embedding every hi increment (every ~3 keys of a 13M-key store) showed
    up as a multi-2^32 "delta", forcing d_hi byte planes for ALL keys
    (kp=5, measured 101 MB drain); in the tight embedding sorted
    consecutive deltas are the true ~2^19 key gaps (kp=3, 67 MB).

    hi is XOR-biased by 2^31 first: the store is sorted in int32
    lexicographic order, and int32 order equals uint32 order of
    (hi ^ 2^31) — so tight keys of a sorted store are monotone even for
    k=31 where the packed hi word goes negative. The codec stays exact
    for ANY order regardless: deltas wrap mod 2^64 and _decode_planes
    unwraps in biased tight space before unbiasing."""
    hi_u = hi.astype(jnp.uint32) ^ jnp.uint32(_SIGN)
    lo_u = lo.astype(jnp.uint32)
    if s < 32:  # tight embedding: key = hi_u * 2^s + lo, relimbed at bit 32
        t_hi = hi_u >> jnp.uint32(32 - s)
        t_lo = (hi_u << jnp.uint32(s)) | (lo_u & jnp.uint32((1 << s) - 1))
    else:
        t_hi, t_lo = hi_u, lo_u
    ph = jnp.concatenate([jnp.zeros(1, jnp.uint32), t_hi[:-1]])
    plo = jnp.concatenate([jnp.zeros(1, jnp.uint32), t_lo[:-1]])
    d_lo = t_lo - plo
    borrow = (t_lo < plo).astype(jnp.uint32)
    d_hi = t_hi - ph - borrow
    return d_hi, d_lo, ct > 0


@functools.partial(jax.jit, static_argnames=("s",))
def _plane_maxima(hi, lo, ct, s: int = 32):
    """-> uint32[5]: max over the VALID prefix of (d_lo, d_hi, count),
    then (hi[0], lo[0]).

    Element 0's delta (= the absolute 42..62-bit key) is EXCLUDED from the
    maxima and returned as its own pair instead: including it forced a
    d_hi byte plane on every drain (kp 5 vs the 3 typical deltas need —
    a ~1.5x wire-bytes difference), since consecutive-key deltas of even a
    fully random 13M-key store stay below 2^24 while key[0] does not."""
    d_hi, d_lo, ok = _delta_limbs(hi, lo, ct, s=s)
    ok = ok & (jnp.arange(ok.shape[0]) > 0)
    z = jnp.uint32(0)
    return jnp.stack([
        jnp.max(jnp.where(ok, d_lo, z)),
        jnp.max(jnp.where(ok, d_hi, z)),
        jnp.max(jnp.where(ct > 0, ct.astype(jnp.uint32), z)),
        hi[0].astype(jnp.uint32),
        lo[0].astype(jnp.uint32),
    ])


@functools.partial(jax.jit, static_argnames=("kp", "cp", "s"))
def _plane_pack(hi, lo, ct, kp: int, cp: int, s: int = 32):
    """-> uint8[(kp+cp)*n]: kp delta byte planes (planes 0-3 from the low
    limb, 4+ from the high limb) then cp count byte planes, concatenated.

    Element 0's delta is zeroed (its absolute key ships via _plane_maxima
    and seeds the host cumsum), so kp only needs to cover consecutive-key
    deltas."""
    d_hi, d_lo, _ = _delta_limbs(hi, lo, ct, s=s)
    first = jnp.arange(d_lo.shape[0]) == 0
    d_lo = jnp.where(first, jnp.uint32(0), d_lo)
    d_hi = jnp.where(first, jnp.uint32(0), d_hi)
    planes = []
    for pidx in range(kp):
        src, sh = (d_lo, 8 * pidx) if pidx < 4 else (d_hi, 8 * (pidx - 4))
        planes.append(((src >> jnp.uint32(sh)) & jnp.uint32(0xFF))
                      .astype(jnp.uint8))
    ct_u = ct.astype(jnp.uint32)
    for pidx in range(cp):
        planes.append(((ct_u >> jnp.uint32(8 * pidx)) & jnp.uint32(0xFF))
                      .astype(jnp.uint8))
    return jnp.concatenate(planes)


def _planes_needed(max_val: int) -> int:
    n = 1
    while max_val >= (1 << (8 * n)):
        n += 1
    return n


def _biased_key0(key0: int, s: int) -> int:
    """Raw (hi << 32) | lo limb pair -> biased tight-embedding value."""
    return ((((key0 >> 32) ^ _SIGN) << s)
            | ((key0 & 0xFFFFFFFF) & ((1 << s) - 1))) & ((1 << 64) - 1)


def _decode_planes(planes: np.ndarray, m: int, kp: int, cp: int,
                   key0: int = 0, s: int = 32):
    """Inverse of _plane_pack on the host: -> (hi, lo int32, ct int64).
    ``key0`` is the absolute first key as the raw (hi << 32) | lo limb
    pair (element 0's delta is zeroed on the wire); the cumsum is seeded
    with its biased tight-embedding value.

    One native C++ pass when available (faster than the numpy column
    decode); the numpy fallback below is the reference implementation."""
    try:
        from mini_parallel.native.kmer_store import decode_planes_native

        return decode_planes_native(np.asarray(planes), m, kp, cp,
                                    _biased_key0(key0, s), s)
    except Exception:  # noqa: BLE001 — no toolchain/lib: numpy fallback
        return _decode_planes_np(planes, m, kp, cp, key0, s)


def _decode_planes_np(planes: np.ndarray, m: int, kp: int, cp: int,
                      key0: int = 0, s: int = 32):
    """NumPy reference decoder (see _decode_planes)."""
    b = planes.size // (kp + cp)
    pl = planes.reshape(kp + cp, b)[:, :m]
    # assemble the uint64 deltas by byte COLUMN (plane p is byte p of the
    # little-endian delta: bits [8p, 8p+8) for p < 4, [32+8(p-4), ...) for
    # p >= 4 — i.e. byte index p either way). Column copies + one view are
    # ~4x cheaper than kp shift/or passes over 8-byte lanes.
    buf = np.zeros((m, 8), np.uint8)
    for pidx in range(kp):
        buf[:, pidx] = pl[pidx]
    delta = buf.view("<u8").ravel()
    # deltas live in biased tight space (_delta_limbs): seed the cumsum
    # with key0 mapped the same way, split + unbias after
    delta[0] += np.uint64(_biased_key0(key0, s))
    keys = np.cumsum(delta, dtype=np.uint64)
    hi = ((keys >> np.uint64(s)).astype(np.uint32)
          ^ np.uint32(_SIGN)).astype(np.int32)
    lo = (keys & np.uint64((1 << s) - 1)).astype(np.uint32).astype(np.int32)
    if cp == 0:  # all counts are 1 (shipped plane-free; see drain())
        ct = np.ones(m, np.int64)
    else:
        cbuf = np.zeros((m, 8), np.uint8)
        for pidx in range(cp):
            cbuf[:, pidx] = pl[kp + pidx]
        ct = cbuf.view("<u8").ravel().astype(np.int64)
    return hi, lo, ct


def _pow2_ceil(n: int, lo: int = 8, hi: int | None = None) -> int:
    b = lo
    while b < n:
        b <<= 1
    return min(b, hi) if hi is not None else b


def _bucket_ceil(n: int, lo: int = 8, hi: int | None = None,
                 frac_bits: int = 3) -> int:
    """Power-of-two bucket with ``frac_bits`` mantissa bits: the next value
    of form (2^frac_bits + f) << s, f in [0, 2^frac_bits). Up to 8 jit
    shapes per octave instead of 1, but the slack is <= 12.5% instead of
    <= 100% — used for the drain's compressed fetch, where a full-octave
    bucket shipped up to 2x the needed wire bytes (13M keys -> 16.7M-slot
    planes; 22% of the drain's 101 MB was sentinel padding)."""
    if n <= lo:
        return lo
    s = max(0, n.bit_length() - 1 - frac_bits)
    b = -(-n >> s) << s  # ceil to the (1 << s) granularity
    return min(b, hi) if hi is not None else b


_EMPTY_ARRAYS = (np.empty(0, np.int32), np.empty(0, np.int32),
                 np.empty(0, np.int64))


def _combined_keys(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 limb pairs -> uint64 keys preserving the SIGNED lex
    order the device store uses (k=31 hi limbs fill 32 bits, so the sign
    bit is live there; biasing hi by 2^31 maps signed order to unsigned)."""
    uhi = (hi.astype(np.int64) + np.int64(1 << 31)).astype(np.uint64)
    ulo = (lo.astype(np.int64) & np.int64(0xFFFFFFFF)).astype(np.uint64)
    return (uhi << np.uint64(32)) | ulo


def _keys_if_sorted_unique(hi: np.ndarray, lo: np.ndarray):
    """Combined uint64 keys when (hi, lo) is strictly ascending, else None.

    Builds the keys ONCE so callers can reuse them for searchsorted — the
    hot 13M-key final fold must not pay four O(n) key passes (review
    round-3 finding)."""
    k = _combined_keys(hi, lo)
    if k.size < 2 or bool(np.all(k[1:] > k[:-1])):
        return k
    return None


def merge_sorted_arrays(a: tuple, b: tuple) -> tuple:
    """Merge two (hi, lo, count) triples into one sorted, deduplicated triple
    (int64 counts). Host-side; used by the checkpoint base fold and the
    engine's final (base, drain) fold.

    Each input is expected sorted+unique (the drain/checkpoint contract),
    letting an empty-side call return the other side directly (the common
    final fold — the old unconditional lexsort cost seconds at 13M keys).
    The two-sided case exploits per-side uniqueness harder than a generic
    rank merge: a key can appear at most once per side, so duplicate
    counts fold DIRECTLY into b's slot (one indexed add, no reduceat) and
    the surviving a-keys scatter straight to their merged ranks — writes
    at strictly-increasing positions, no permutation gathers, no RLE pass
    (the old permute+reduceat path spent ~75% of a 13M+8M fold in random
    gathers and np.add.reduceat). Unsorted inputs still work: a cheap
    monotonicity check falls back to a lexsort + RLE path."""
    ka = _keys_if_sorted_unique(a[0], a[1])
    kb = _keys_if_sorted_unique(b[0], b[1])
    if a[0].size == 0 and kb is not None:
        return b[0], b[1], b[2].astype(np.int64)
    if b[0].size == 0 and ka is not None:
        return a[0], a[1], a[2].astype(np.int64)
    if a[0].size and b[0].size and ka is not None and kb is not None:
        # keys present on both sides: each matches at most ONE b slot
        pos = np.searchsorted(kb, ka, side="left")
        inb = pos < kb.size
        match = np.zeros(ka.size, bool)
        match[inb] = kb[pos[inb]] == ka[inb]
        ct_b = b[2].astype(np.int64).copy()
        ct_b[pos[match]] += a[2][match].astype(np.int64)
        keep = ~match
        ka_u = ka[keep]
        # merged rank = own index + rank in the other run (no ties left);
        # pos[keep] IS the kept keys' rank in kb — don't re-searchsorted
        ra = pos[keep] + np.arange(ka_u.size)
        rb = np.searchsorted(ka_u, kb, side="left") + np.arange(kb.size)
        n = ka_u.size + kb.size
        hi = np.empty(n, a[0].dtype)
        lo = np.empty(n, a[1].dtype)
        ct = np.empty(n, np.int64)
        hi[ra] = a[0][keep]
        hi[rb] = b[0]
        lo[ra] = a[1][keep]
        lo[rb] = b[1]
        ct[ra] = a[2][keep].astype(np.int64)
        ct[rb] = ct_b
        return hi, lo, ct
    hi = np.concatenate([a[0], b[0]])
    lo = np.concatenate([a[1], b[1]])
    ct = np.concatenate([a[2].astype(np.int64), b[2].astype(np.int64)])
    if hi.size == 0:
        return _EMPTY_ARRAYS
    order = np.lexsort((lo, hi))
    hi, lo, ct = hi[order], lo[order], ct[order]
    new = np.empty(hi.size, bool)
    new[0] = True
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    idx = np.flatnonzero(new)
    return hi[idx], lo[idx], np.add.reduceat(ct, idx)



class DeviceKmerAccumulator:
    """Cross-batch k-mer aggregate kept entirely in HBM.

    add() appends a batch's compacted uniques (fixed slot count per batch)
    into device staging; a sorted merge folds staging into the store every
    ``staging_batches`` appends. drain() does the single device->host fetch.
    If the distinct count ever exceeds ``capacity``, the store spills to a
    host-side SORTED (hi, lo, ct) triple — each spill is already sorted+
    unique (the fold contract), so spills fold with the rank merge
    (merge_sorted_arrays) instead of hash-store inserts, and the final
    drain needs no full-table lexsort — and restarts empty, so results
    stay exact at any cardinality.
    """

    # upper bound on staging slots (~800 MB at 3 x int32): staging_batches
    # is clamped so huge per-batch slot counts cannot blow HBM
    MAX_STAGING_SLOTS = 1 << 26

    def __init__(self, capacity: int = 1 << 25, staging_batches: int = 40,
                 lo_bits: int = 32):
        # staging 40 (vs 8) measured +9% on the all-distinct worst case:
        # fewer store folds for the same total sort work
        self.capacity = capacity
        self.staging_batches = staging_batches
        # true bit width of the lo word (2*(k//2) for pack_kmers keys):
        # lets the drain codec take deltas in the tight key embedding
        # (see _delta_limbs) — kp 5 -> 3 on the 13M-key worst case
        self.lo_bits = lo_bits
        self._spill_arrays = _EMPTY_ARRAYS  # sorted+unique host fold
        # spills fetch+fold on a background worker: the device arrays are
        # immutable, so counting continues on a fresh store while the host
        # does its ~10-20 s of fetch + rank merge per overflow (inline it
        # was the spill regime's wall after the codec fix: merges 37 s of
        # a 90 s 1.25M-read lane). One worker serializes the folds.
        self._spill_thread = None
        self._spill_error = None
        self.spilled = False
        self._store = None  # (hi, lo, ct) device arrays, sorted+compacted
        self._staging = None  # (hi, lo, ct) device arrays, append-only
        self._slot = 0  # slots per batch (fixed once first batch arrives)
        self._off = 0
        self._pending = 0
        # host-side upper bound on (distinct keys, max per-key count) since
        # the last restart: lets flush() skip the blocking n_unique fetch
        # while the bound proves no overflow, and forces a spill before any
        # int32 per-key count could wrap (counts are int32 on device; the
        # host spill store aggregates in int64)
        self._added = 0
        # distinct upper bound for the STORE alone: folds sort only the
        # power-of-two prefix this proves occupied (async-safe), so early
        # folds on sparse stores never pay the full-capacity sort
        self._store_bound = 0

    def _reset_staging(self):
        batches = min(self.staging_batches,
                      max(1, self.MAX_STAGING_SLOTS // max(self._slot, 1)))
        # round DOWN to a power of two: the rank-merge fold tree-merges the
        # staged runs pairwise, so a 2^r run count keeps every level's
        # shape uniform (40 -> 32; the batch-count tuning curve is flat
        # there, and unoccupied runs are sentinel-filled so partial flushes
        # just take the next power of two <= allocation)
        batches = 1 << max(0, batches.bit_length() - 1)
        self._effective_batches = batches
        n = self._slot * batches
        z = jnp.full((n,), _SENTINEL, jnp.int32)
        self._staging = (z, z.copy(), jnp.zeros((n,), jnp.int32))
        self._off = 0
        self._pending = 0

    def add(self, hi, lo, ct) -> None:
        """Append one batch's (hi, lo, counts) slab (uniques compacted and
        SORTED by key — the unique_counts_* contract — zero-count padding
        allowed; the rank-merge fold relies on per-slab sortedness)."""
        n = hi.shape[0]
        if self._staging is None:
            self._slot = n
        elif n != self._slot:
            # shape change (e.g. final partial chunk bucketed differently):
            # fold what we have, then restart staging at the new slot size
            # (reset_staging=False: the old-geometry staging arrays would be
            # reallocated only to be discarded here — a ~3x slot*batches
            # transient HBM spike at production sizes)
            self.flush(reset_staging=False)
            self._slot = n
        if self._staging is None:
            self._reset_staging()
        sh, sl, sc = self._staging
        self._staging = _staging_append(sh, sl, sc, self._off, hi, lo, ct)
        self._off += n
        self._added += n
        self._pending += 1
        if self._pending >= getattr(self, "_effective_batches",
                                    self.staging_batches):
            self.flush()


    _INT32_SAFE = (1 << 31) - (1 << 26)  # headroom > any single staging fold

    def _after_fold(self, reset_staging: bool) -> None:
        if reset_staging:
            self._reset_staging()
        else:  # caller is about to change slot geometry: drop, don't realloc
            self._staging = None
            self._off = 0
            self._pending = 0

    def flush(self, reset_staging: bool = True) -> None:
        """Fold staging into the store (one sorted merge in HBM).

        Fully asynchronous while the added-slots bound proves the store
        cannot overflow; only past that bound does it pay one scalar fetch
        per fold to check the true unique count.

        Compile-cost note (advisor round 2): prefix-sorted folds make each
        power-of-two growth of the (store, staging) prefix pair a fresh
        _sorted_merge shape, so a growing store pays O(log2(capacity))
        one-time compiles (cached after). Accepted log-bounded tradeoff: the alternative fixed-cap
        fold compiled once but sorted the full 33.5M+52M slot arrays on
        EVERY fold, which measured far slower than a handful of transient
        compiles amortized by the persistent compile cache."""
        if self._staging is None or self._pending == 0:
            if self._staging is not None and not reset_staging:
                self._after_fold(False)
            return
        import os

        sh, sl, sc = self._staging
        # fold only the occupied power-of-two prefixes: _pending bounds the
        # staged runs, _store_bound the store's distinct count — both
        # host-side bounds, no sync; on repetitive (real) data folds stay
        # at the small prefix forever.
        if self._store is None:
            z8 = jnp.full((8,), _SENTINEL, jnp.int32)
            store_in = (z8, z8.copy(), jnp.zeros((8,), jnp.int32))
        else:
            S = _pow2_ceil(self._store_bound, hi=self._store[0].shape[0])
            store_in = tuple(x[:S] for x in self._store)
        if not os.environ.get("MPT_KMER_RANK_FOLD"):
            # default: comparison sort of the concatenated slabs; the
            # searchsorted rank merge below was the slower of the two where
            # first measured (see _sorted_merge). Kept behind
            # MPT_KMER_RANK_FOLD as a negative result; do not flip without
            # measuring on the GPU.
            P = _pow2_ceil(self._off, hi=sh.shape[0])
            hi, lo, ct, nu = _sorted_merge(*store_in, sh[:P], sl[:P], sc[:P])
        else:
            # negative-result path: tree rank-merge of the already-sorted
            # staged runs (pow2 run count; unoccupied runs are sentinel-
            # filled), then one two-way rank merge against the store prefix
            P2 = 1
            while P2 < max(self._pending, 1):
                P2 <<= 1
            P2 = min(P2, sh.shape[0] // max(self._slot, 1))
            w = P2 * self._slot
            mh, ml, mc = _rank_merge_runs(
                sh[:w].reshape(P2, self._slot),
                sl[:w].reshape(P2, self._slot),
                sc[:w].reshape(P2, self._slot),
            )
            hi, lo, ct, nu = _rank_merge_pair(*store_in, mh, ml, mc)
        self._store_bound = min(self._store_bound + self._off,
                                self.capacity)
        if self._added <= min(self.capacity, self._INT32_SAFE):
            # bound proof: distinct <= added <= capacity, and no per-key
            # count can exceed added -> no overflow check needed (no sync)
            self._store = (hi[: self.capacity], lo[: self.capacity],
                           ct[: self.capacity])
            self._after_fold(reset_staging)
            return
        if self._added > self._INT32_SAFE or int(nu) > self.capacity:
            # overflow: spill the FULL merged result (pre-truncation) to the
            # host store so no unique is ever dropped, then restart empty
            self._spill(hi, lo, ct)
            self._store = None
            self._added = 0
            self._store_bound = 0
        else:
            self._store = (hi[: self.capacity], lo[: self.capacity],
                           ct[: self.capacity])
        self._after_fold(reset_staging)

    def _spill(self, hi, lo, ct) -> None:
        # compressed fetch (same codec as drain): the old raw np.asarray
        # shipped the full 3-slab pre-truncation arrays per overflow —
        # ~60 s of an on-chip 70 s forced-spill profile was these fetches.
        # The host fold is a rank merge of sorted+unique triples (the
        # store-fold contract guarantees both sides), replacing hash-store
        # inserts + a final full-table lexsort. Both run on the background
        # worker; `hi/lo/ct` are immutable device arrays, safe to read
        # after the store restarts.
        import threading

        prev = self._spill_thread

        def fold():
            try:
                if prev is not None:
                    prev.join()
                if self._spill_error is not None:
                    return
                self._spill_arrays = merge_sorted_arrays(
                    self._spill_arrays, self._fetch_triple(hi, lo, ct))
            except BaseException as e:  # noqa: BLE001 — re-raised at drain
                self._spill_error = e

        self._spill_thread = threading.Thread(
            target=fold, daemon=True, name="mpt-kmer-spill")
        self._spill_thread.start()
        self.spilled = True

    def _join_spills(self) -> None:
        if self._spill_thread is not None:
            self._spill_thread.join()
            self._spill_thread = None
        if self._spill_error is not None:
            # the flag stays SET (accumulator poisoned): spill folds after
            # the failure were skipped, so any later drain() would return a
            # silent undercount — every retry must fail loudly instead
            raise RuntimeError(
                "k-mer spill fold failed; counts in this accumulator are "
                "incomplete (recount required)"
            ) from self._spill_error

    def summary(self, top_n: int = 10, hist_bins: int = 64):
        """Device-side summary — NO table drain.

        Returns {"n_unique": int, "hist": int64[hist_bins] (hist[c-1] =
        number of distinct k-mers with count c for c < hist_bins; the last
        bin aggregates counts >= hist_bins), "top": [(hi, lo, count), ...]
        descending by count, ties broken by ascending key — identical to
        KmerResult.top()'s host ordering on the sorted store}.

        The wire cost is O(top_n + hist_bins) scalars instead of the full
        (hi, lo, ct) table (41.5 MB compressed at 13M keys).
        Returns None when exactness would require the host spill store
        (capacity overflow): callers must fall back to drain().
        """
        self.flush()
        if self.spilled:
            return None
        if self._store is None:
            return {"n_unique": 0,
                    "hist": np.zeros(hist_bins, np.int64), "top": []}
        S = _pow2_ceil(max(self._store_bound, 1),
                       hi=self._store[0].shape[0])
        hi_d, lo_d, ct_d = (x[:S] for x in self._store)
        n, hist, tv, th, tl = _summary_store(
            hi_d, lo_d, ct_d, top_n=min(top_n, S), hist_bins=hist_bins
        )
        import jax

        n, hist, tv, th, tl = jax.device_get((n, hist, tv, th, tl))
        top = [(int(h), int(l), int(c))
               for c, h, l in zip(tv, th, tl) if c > 0]
        return {"n_unique": int(n), "hist": hist.astype(np.int64),
                "top": top}

    def _fetch_triple(self, hi_d, lo_d, ct_d):
        """Compressed fetch of the valid prefix of a sorted, compacted
        (hi, lo, ct) device triple -> host int32/int32/int64 arrays.

        Shared by drain() AND _spill(): delta + byte-plane compressed
        (~3x fewer wire bytes; see _plane_pack). Deltas wrap mod 2^64 and
        the host cumsum unwraps them, so this is exact for ANY key
        ordering — only the ratio depends on sortedness. Eighth-octave
        buckets: the fetch is the wall, so <=12.5% slack beats
        one-shape-per-octave compile thrift. Small triples (or
        MPT_KMER_RAW_DRAIN) take the raw bucketed slice."""
        import os

        cap = hi_d.shape[0]
        m = int((ct_d > 0).sum())
        if (m > COMPRESS_MIN_KEYS
                and not os.environ.get("MPT_KMER_RAW_DRAIN")):
            b = _bucket_ceil(m, lo=1 << 10, hi=cap)
            s = self.lo_bits
            hi_b, lo_b, ct_b = hi_d[:b], lo_d[:b], ct_d[:b]
            mx = np.asarray(_plane_maxima(hi_b, lo_b, ct_b, s=s))
            mx_lo, mx_hi, mx_ct, k0_hi, k0_lo = (int(x) for x in mx)
            kp = (4 + _planes_needed(mx_hi)) if mx_hi \
                else _planes_needed(mx_lo)
            # all-ones counts (the all-distinct worst case) ship ZERO
            # count planes — the decoder reconstructs them (25% of the
            # wire on a 13M-key worst-case drain)
            cp = 0 if mx_ct == 1 else _planes_needed(mx_ct)
            planes = np.asarray(_plane_pack(hi_b, lo_b, ct_b, kp, cp, s=s))
            key0 = (k0_hi << 32) | k0_lo
            return _decode_planes(planes, m, kp, cp, key0, s=s)
        b = _pow2_ceil(m, lo=1 << 10, hi=cap)
        hi = np.asarray(hi_d[:b])[:m]
        lo = np.asarray(lo_d[:b])[:m]
        ct = np.asarray(ct_d[:b])[:m].astype(np.int64)
        return hi, lo, ct

    def drain(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Final fetch: (hi, lo, counts) of every distinct k-mer.

        Fetches only the used prefix of the store: one scalar round trip
        for the distinct count, then compressed bucketed slices — the
        full capacity slab is 3 x 128 MB at the default 1<<25, a drain-time
        wall on thin links when the data is repetitive (distinct <<
        capacity)."""
        self.flush()
        if self._store is not None:
            hi_d, lo_d, ct_d = self._store
            hi, lo, ct = self._fetch_triple(hi_d, lo_d, ct_d)
        else:
            hi = np.empty(0, np.int32)
            lo, ct = hi.copy(), np.empty(0, np.int64)
        if self.spilled:  # fold the device remainder into the host spill
            # both sides sorted+unique -> rank merge; output order is the
            # signed (hi, lo) lex order the old lexsort/dict-sort produced
            self._join_spills()  # background folds must land (or raise)
            hi, lo, ct = merge_sorted_arrays(self._spill_arrays,
                                             (hi, lo, ct))
        return hi, lo, ct


@functools.partial(jax.jit, static_argnames=("top_n", "hist_bins"))
def _summary_store(hi, lo, ct, top_n: int, hist_bins: int):
    """Distinct count, multiplicity histogram, and top-N of a store slab.

    Empty slots have ct == 0. Histogram bin b (1-based count) is exact for
    counts 1..hist_bins-1; bin hist_bins aggregates the tail. top_k ties
    resolve to the lower index = the smaller key (the store is key-sorted),
    matching the host lexsort((lo, hi, -ct)) tie-break in KmerResult.top().
    """
    valid = ct > 0
    n_unique = valid.astype(jnp.int32).sum()
    idx = jnp.clip(ct, 0, hist_bins)
    hist = jnp.zeros((hist_bins + 1,), jnp.int32).at[idx].add(
        valid.astype(jnp.int32)
    )[1:]  # bin 0 would count empty slots
    tv, ti = jax.lax.top_k(jnp.where(valid, ct, jnp.int32(-1)), top_n)
    return n_unique, hist, tv, jnp.take(hi, ti), jnp.take(lo, ti)


def key_to_string(hi: int, lo: int, k: int = DEFAULT_K) -> str:
    """Decode a (hi, lo) key back to its ACGT string (host, debugging/tests)."""
    k_hi = (k + 1) // 2
    bases = "ACGT"
    out = []
    v = int(hi)
    for _ in range(k_hi):
        out.append(bases[v & 3])
        v >>= 2
    head = "".join(reversed(out))
    out = []
    v = int(lo)
    for _ in range(k - k_hi):
        out.append(bases[v & 3])
        v >>= 2
    return head + "".join(reversed(out))


def count_kmers_python(reads: list[bytes], k: int = DEFAULT_K,
                       canonical: bool = False) -> Counter:
    """Pure-Python golden counter (tests / small inputs)."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    c: Counter = Counter()
    for r in reads:
        r = r.upper()
        for j in range(len(r) - k + 1):
            w = r[j : j + k]
            if any(b not in b"ACGT" for b in w):
                continue
            if canonical:
                rc = w.translate(comp)[::-1]
                w = min(w, rc)
            c[w.decode()] += 1
    return c


def merge_device_counts(
    agg: dict, key_hi: np.ndarray, key_lo: np.ndarray, counts: np.ndarray
) -> dict:
    """Merge one device batch's (keys, counts) into a host accumulator dict
    keyed by the 42-bit integer (hi << 32 | lo_bits... stored as (hi, lo))."""
    nz = counts > 0
    for h, l, ct in zip(key_hi[nz].tolist(), key_lo[nz].tolist(), counts[nz].tolist()):
        key = (h, l)
        agg[key] = agg.get(key, 0) + ct
    return agg
