"""Exact Smith-Waterman for LONG sequence pairs: full-height column strips.

The reference hard-caps a single alignment launch and errors beyond it
(smith_waterman/src/aligner.rs:436-456: min(16.7M work items, VRAM/3) then
"Sequence too large for GPU processing"). This module scores one pair of
arbitrarily long sequences EXACTLY, bounded by runtime rather than memory
(SURVEY.md §5 long-context: "the DP grid is tiled and boundary rows/columns
are carried between tiles").

Design (differs from the batched scorers, which batch many short pairs):

- The DP grid (M rows = seq_a, N cols = seq_b) is cut into **column strips**
  of width W spanning the FULL row range. Within a strip, element
  e owns **one fixed column** j0+e; at sweep step t it computes cell
  (i = t - e, j0 + e). Consequences, all wavefront-friendly:
    * UP neighbor (i-1, j) = same element, previous step — **no shift**;
    * LEFT (i, j-1) = element e-1, previous step — one shift;
    * DIAG (i-1, j-1) = element e-1, two steps back — carried pre-shifted
      (d1s).
- Because strips are full-height, the top boundary is the true DP edge
  (zeros) — only the **right boundary column** is carried between strips
  (rightcol[i] = H[i][j0+W-1]), produced by one sweep and fed to the next
  strip as leftcol. The carried column enters at element 0 through the
  shift, one value per step; the query base enters the same way.
- One strip's sweep is a ``lax.scan`` over its steps whose body is a few
  elementwise operations over the W-wide state, which XLA fuses. The scan
  consumes the query and the left column one value per step and emits the
  corner cell, so the strip's I/O needs no gathers.

Every array is flat: the strip's state and subject codes are (W,), the
query and the carried boundary column (T,) for a T-step sweep.

Scoring: match +2 / mismatch -1 / gap -2, local alignment (floor 0) —
ops/sw.py semantics; validated against a blocked NumPy golden in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_parallel.ops.encode import PAD_A, PAD_B
from mini_parallel.ops.sw import GAP_PENALTY, MATCH_SCORE, MISMATCH_PENALTY

# 262144-column strips: on a GPU each sweep step is one fused pass over the
# strip, so wide strips (fewer, longer sweeps) cut the per-step loop
# overhead; the scorers narrow the strip to the b length.
DEFAULT_WIDTH = 1 << 18
WIDTH_STEP = 1024  # strip widths round up to this, so nearby lengths share
DEFAULT_BLK = 16_384  # sweep lengths are rounded up to a multiple of this
UNROLL = 8  # sweep steps per scan iteration


def _as_codes(seq: bytes | np.ndarray) -> np.ndarray:
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(seq, np.uint8)
    return np.asarray(seq, np.uint8)


def strip_width(width: int, n: int) -> int:
    """The strip width for an n-column subject: ``width``, narrowed to n
    rounded up to WIDTH_STEP (a 262144-wide strip for a 9k subject would
    waste most of every sweep step)."""
    return min(width, -(-n // WIDTH_STEP) * WIDTH_STEP)


def cold_state(W: int) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Wavefront state above the DP's first row: empty window, zero H."""
    return (jnp.full((W,), int(PAD_A), jnp.int32),
            jnp.zeros((W,), jnp.int32),
            jnp.zeros((W,), jnp.int32))


@jax.jit
def _run_strip(
    b: jnp.ndarray,            # (W,) int32, column codes of this strip
    a: jnp.ndarray,            # (T,) int32, a codes, one per sweep step
    leftcol: jnp.ndarray,      # (T,) int32, carried boundary column
    state: tuple | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, tuple]:
    """Sweep one strip over T steps starting from ``state`` (cold_state if
    None). Returns (best (), rightcol (T,), final state) — the state
    threading is what lets a sweep split across row bands on a device mesh
    (halo exchange)."""
    w0, d10, d1s0 = cold_state(b.shape[0]) if state is None else state

    def step(carry, io):
        w, d1, d1s, best = carry
        a_t, lc_t = io
        w = jnp.concatenate([a_t[None], w[:-1]])
        diag = d1s + jnp.where(w == b, MATCH_SCORE, MISMATCH_PENALTY)
        sh = jnp.concatenate([lc_t[None], d1[:-1]])
        # up = d1 (same element, previous step); left = sh
        cand = jnp.maximum(
            jnp.maximum(diag, jnp.maximum(d1, sh) + GAP_PENALTY), 0)
        return (w, cand, sh, jnp.maximum(best, cand)), cand[-1]

    (w, d1, d1s, best), rc = jax.lax.scan(
        step, (w0, d10, d1s0, d10 * 0), (a, leftcol), unroll=UNROLL)
    return jnp.max(best), rc, (w, d1, d1s)


def sw_score_long(
    seq_a: bytes | np.ndarray,
    seq_b: bytes | np.ndarray,
    width: int = DEFAULT_WIDTH,
    blk: int = DEFAULT_BLK,
    progress=None,
) -> int:
    """Exact linear-gap SW score of ONE long pair via column-strip sweeps.

    Capability anchor: the reference errors out above ~16.7M work items
    (aligner.rs:436-456); this path is bounded only by runtime (O(M*N)
    cells) and O(M + N) HBM for the carried boundary column — a >=100x cap
    lift. Memory: sequences as 1-byte codes + one (M,) int32 boundary.

    seq_a/seq_b: ASCII bytes or uint8 arrays. Returns int score.
    """
    a, b = _as_codes(seq_a), _as_codes(seq_b)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    W = strip_width(width, N)
    # sweep length: wavefront needs M + W - 1 steps; round to the block
    T = -(-(M + W) // blk) * blk
    a_pad = np.full(T, PAD_A, np.int32)
    a_pad[:M] = a
    a_dev = jnp.asarray(a_pad)
    lc = jnp.zeros((T,), jnp.int32)

    best_dev = jnp.zeros((), jnp.int32)
    n_strips = -(-N // W)
    for si in range(n_strips):
        j0 = si * W
        bt = np.full(W, PAD_B, np.int32)
        seg = b[j0 : j0 + W]
        bt[: seg.size] = seg
        best, rc, _state = _run_strip(jnp.asarray(bt), a_dev, lc)
        # wavefront skew: the corner element emits H[d-(W-1)][j_last] at
        # step d, so rightcol row i sits at flat index i + W - 1; the next
        # strip consumes leftcol[d'] = H[d'][j_last] -> shift forward W-1
        lc = _shift_rows(rc, W - 1)
        best_dev = jnp.maximum(best_dev, jnp.max(best))
        if progress:
            progress(f"  sw-long strip {si + 1}/{n_strips} "
                     f"(cols {j0}-{min(j0 + W, N)})")
    return int(np.asarray(best_dev))


@functools.partial(jax.jit, static_argnames=("shift", "fill"))
def _shift_rows(rc: jnp.ndarray, shift: int, fill: int = 0) -> jnp.ndarray:
    """out[i] = rc[i + shift], the tail filled with ``fill``."""
    return jnp.full_like(rc, fill).at[: rc.size - shift].set(rc[shift:])


def sw_score_numpy_blocked(seq_a: bytes, seq_b: bytes) -> int:
    """Vectorized NumPy anti-diagonal golden for sizes where the quadratic
    Python-loop oracle (ops/sw.py:sw_score_numpy) is too slow. O(M+N)
    memory, numpy-vector ops per diagonal."""
    a = np.frombuffer(seq_a, np.uint8).astype(np.int64)
    b = np.frombuffer(seq_b, np.uint8).astype(np.int64)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    # diagonal index d holds cells (i, d - i) for i in [max(0,d-N+1), min(d,M-1)]
    prev = np.zeros(M + 1, np.int64)   # H on diagonal d-1, indexed by i+1
    prev2 = np.zeros(M + 1, np.int64)  # H on diagonal d-2
    best = 0
    for d in range(M + N - 1):
        lo = max(0, d - N + 1)
        hi = min(d, M - 1)
        i = np.arange(lo, hi + 1)
        j = d - i
        s = np.where(a[i] == b[j], MATCH_SCORE, MISMATCH_PENALTY)
        diag = prev2[i] + s          # H[i-1][j-1]: prev2 index (i-1)+1
        up = prev[i]                 # H[i-1][j]:   prev index (i-1)+1
        left = prev[i + 1]           # H[i][j-1]:   prev index i+1
        h = np.maximum(
            np.maximum(diag, np.maximum(up, left) + GAP_PENALTY), 0
        )
        best = max(best, int(h.max()))
        prev2 = prev
        cur = np.zeros(M + 1, np.int64)
        cur[i + 1] = h
        prev = cur
    return best


# ---------------------------------------------------------------------------
# Multi-chip long-pair SW: the seq-axis halo-exchange pipeline the blueprint
# promises (SURVEY.md §5: "across chips via halo exchange on the sequence
# axis"). Rows split into one BAND per chip; for each strip, a chip resumes
# the sweep from the (w, d1, d1s) wavefront state its predecessor exported —
# that state IS the halo. Chips pipeline systolically: chip c sweeps strip
# k at stage k + c, so with C chips and K strips the wall is (K + C - 1)
# band-sweeps instead of K full sweeps (~C x for K >> C).
#
# The boundary-column subtlety: chip c's next-strip leftcol needs rightcol
# values for its band's last W-1 rows, which the wavefront skew places in
# the SUCCESSOR's sweep — mid-stage, too late to communicate. Instead each
# chip re-sweeps W-1 steps past its band (the a-row halo) and harvests the
# tail locally. The overlap's own leftcol input is garbage (zeros), but
# that only affects cells of rows >= the band end, and a harvested
# rightcol row i is computed before any row >= i+1 cell can influence it —
# so the tail is exact (duplicated work: (W-1)/band, ~0.3% at production
# sizes).
# ---------------------------------------------------------------------------


_SHARDED_STAGE_CACHE: dict = {}


def sw_score_long_sharded(
    seq_a: bytes | np.ndarray,
    seq_b: bytes | np.ndarray,
    mesh,
    axis: str = "seq",
    width: int = DEFAULT_WIDTH,
    blk: int = DEFAULT_BLK,
    progress=None,
) -> int:
    """Exact long-pair SW on a device mesh: row bands x pipelined strips."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    a, b = _as_codes(seq_a), _as_codes(seq_b)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    C = int(mesh.shape[axis])
    W = strip_width(width, N)
    K = -(-N // W)
    T = -(-(M + W) // (C * blk)) * (C * blk)
    band = T // C
    if band < W:
        raise ValueError(
            f"band ({band} rows) must cover one strip width ({W}); "
            f"use fewer devices, a narrower strip, or longer sequences"
        )
    # each band re-sweeps the W - 1 rows past its end (the a-row halo)
    a_pad = np.full(T + W - 1, PAD_A, np.int32)
    a_pad[:M] = a
    a_bands = a_pad[:T].reshape(C, band)
    a_halo = np.stack([a_pad[(c + 1) * band: (c + 1) * band + W - 1]
                       for c in range(C)])
    shard = NamedSharding(mesh, P(axis))
    a_bands = jax.device_put(jnp.asarray(a_bands), shard)
    a_halo = jax.device_put(jnp.asarray(a_halo), shard)
    lc = jax.device_put(jnp.zeros((C, band), jnp.int32), shard)
    state = tuple(
        jax.device_put(jnp.zeros((C, W), jnp.int32), shard)
        for _ in range(3)
    )
    best_run = jax.device_put(jnp.zeros((C,), jnp.int32), shard)


    def stage_local(b_cols, a_band, a_hal, lc_in, w0, d10, d1s0, flags,
                    best_in):
        # locals carry a leading (1,) shard dim
        b_t = b_cols[0]
        first = flags[0, 0] != 0
        active = flags[0, 1] != 0
        # chip 0's band starts at the DP's true top edge -> cold for every
        # strip; other chips cold only before their first strip (inactive)
        chip = jax.lax.axis_index(axis)
        use_cold = (chip == 0) | ~active
        # derive the cold state from operands (a fresh constant under
        # shard_map has no varying-axis type)
        cw = w0[0] * 0 + int(PAD_A)
        cz = w0[0] * 0
        w0_, d10_, d1s0_ = (
            jnp.where(use_cold, cw, w0[0]),
            jnp.where(use_cold, cz, d10[0]),
            jnp.where(use_cold, cz, d1s0[0]),
        )
        lc_eff = jnp.where(first, 0, lc_in[0])
        best1, rc1, st_t = _run_strip(
            b_t, a_band[0], lc_eff, state=(w0_, d10_, d1s0_))
        best2, rc2, _ = _run_strip(b_t, a_hal[0], a_hal[0] * 0, state=st_t)
        lc_next = jnp.concatenate([rc1[W - 1:], rc2])
        stage_best = jnp.maximum(best1, best2)
        best_out = jnp.maximum(best_in[0],
                               jnp.where(active, stage_best, 0))
        # halo exchange: this band's final state seeds the next band
        perm = [(i, i + 1) for i in range(C - 1)]
        nw, nd1, nd1s = (
            jax.lax.ppermute(s[None], axis, perm) for s in st_t
        )
        return (lc_next[None], nw, nd1, nd1s, best_out[None])

    spec = P(axis)
    # cache the jitted stage per geometry: a fresh jit(shard_map(closure))
    # per call would never hit jit's function-identity cache and would
    # compile again on every invocation
    key = (mesh, axis, W, blk, band)
    stage_fn = _SHARDED_STAGE_CACHE.get(key)
    if stage_fn is None:
        stage_fn = jax.jit(shard_map(
            stage_local, mesh=mesh,
            in_specs=(spec,) * 9, out_specs=(spec,) * 5,
            check_vma=False,
        ))
        _SHARDED_STAGE_CACHE[key] = stage_fn

    for s in range(K + C - 1):
        b_t, fl = _stage_inputs(b, s, C, K, W, shard)
        lc, *st_and_best = stage_fn(b_t, a_bands, a_halo, lc, *state, fl,
                                    best_run)
        state = tuple(st_and_best[:3])
        best_run = st_and_best[3]
        if progress:
            progress(f"  sw-long-sharded stage {s + 1}/{K + C - 1}")
    return int(np.asarray(jnp.max(best_run)))


def _stage_inputs(b: np.ndarray, s: int, C: int, K: int, W: int, shard):
    """Pipeline stage s: device c sweeps strip s - c. Returns each device's
    strip columns (C, W) and flags (C, 2) = (first strip, active)."""
    b_cols = np.full((C, W), PAD_B, np.int32)
    flags = np.zeros((C, 2), np.int32)
    for c in range(C):
        k = s - c
        if 0 <= k < K:
            seg = b[k * W: (k + 1) * W]
            b_cols[c, : seg.size] = seg
            flags[c] = (1 if k == 0 else 0, 1)
    return (jax.device_put(jnp.asarray(b_cols), shard),
            jax.device_put(jnp.asarray(flags), shard))


# ---------------------------------------------------------------------------
# Affine-gap (Gotoh) long-pair SW: same strip layout, two more carried
# matrices. In strip coordinates the affine states are natural fits:
#   E[i][j] = max(E[i-1][j], H[i-1][j] + go) + ge   (gap in b, consumes a)
#       -> up-neighbor = SAME element, previous step: no shift;
#   F[i][j] = max(F[i][j-1], H[i][j-1] + go) + ge   (gap in a, consumes b)
#       -> left-neighbor = shifted, and F CROSSES strip boundaries, so a
#          second boundary column (rightcol of F) is carried between strips
#          alongside H's.
# ---------------------------------------------------------------------------

from mini_parallel.ops.sw import GAP_EXTEND, GAP_OPEN  # noqa: E402

_NEG_LONG = -(2**24)  # decays by |ge| per step; > int32 min at any length


def cold_state_affine(W: int):
    """Affine wavefront state above the DP's first row."""
    neg = jnp.full((W,), _NEG_LONG, jnp.int32)
    return (jnp.full((W,), int(PAD_A), jnp.int32),
            jnp.zeros((W,), jnp.int32),
            jnp.zeros((W,), jnp.int32),
            neg, neg.copy())


@functools.partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def _run_strip_affine(b, a, lch, lcf, gap_open: int, gap_extend: int,
                      state: tuple | None = None):
    """Affine analogue of :func:`_run_strip`: carries H and F boundary
    columns. Returns (best (), rightcol H (T,), rightcol F (T,), final
    5-array state (w, H, shifted H, E, F))."""
    w0, d10, d1s0, e10, f10 = (cold_state_affine(b.shape[0])
                               if state is None else state)

    def step(carry, io):
        w, d1, d1s, e1, f1, best = carry
        a_t, lch_t, lcf_t = io
        w = jnp.concatenate([a_t[None], w[:-1]])
        diag = d1s + jnp.where(w == b, MATCH_SCORE, MISMATCH_PENALTY)
        sh = jnp.concatenate([lch_t[None], d1[:-1]])    # H(i, j-1)
        shf = jnp.concatenate([lcf_t[None], f1[:-1]])   # F(i, j-1)
        e = jnp.maximum(e1, d1 + gap_open) + gap_extend
        f = jnp.maximum(shf, sh + gap_open) + gap_extend
        cand = jnp.maximum(jnp.maximum(diag, jnp.maximum(e, f)), 0)
        return ((w, cand, sh, e, f, jnp.maximum(best, cand)),
                (cand[-1], f[-1]))

    (w, d1, d1s, e1, f1, best), (rch, rcf) = jax.lax.scan(
        step, (w0, d10, d1s0, e10, f10, d10 * 0), (a, lch, lcf),
        unroll=UNROLL)
    return jnp.max(best), rch, rcf, (w, d1, d1s, e1, f1)


def sw_affine_score_long(
    seq_a: bytes | np.ndarray,
    seq_b: bytes | np.ndarray,
    gap_open: int = GAP_OPEN,
    gap_extend: int = GAP_EXTEND,
    width: int = DEFAULT_WIDTH,
    blk: int = DEFAULT_BLK,
    progress=None,
) -> int:
    """Exact affine-gap (Gotoh) SW for ONE long pair via column strips —
    the affine analogue of sw_score_long; carries BOTH the H and F
    boundary columns between strips."""
    a, b = _as_codes(seq_a), _as_codes(seq_b)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    W = strip_width(width, N)
    T = -(-(M + W) // blk) * blk
    a_pad = np.full(T, PAD_A, np.int32)
    a_pad[:M] = a
    a_dev = jnp.asarray(a_pad)
    lch = jnp.zeros((T,), jnp.int32)
    lcf = jnp.full((T,), _NEG_LONG, jnp.int32)

    best_dev = jnp.zeros((), jnp.int32)
    n_strips = -(-N // W)
    for si in range(n_strips):
        j0 = si * W
        bt = np.full(W, PAD_B, np.int32)
        seg = b[j0 : j0 + W]
        bt[: seg.size] = seg
        best, rch, rcf, _st = _run_strip_affine(
            jnp.asarray(bt), a_dev, lch, lcf, gap_open, gap_extend)
        lch = _shift_rows(rch, W - 1)
        lcf = _shift_rows(rcf, W - 1, _NEG_LONG)
        best_dev = jnp.maximum(best_dev, jnp.max(best))
        if progress:
            progress(f"  sw-affine-long strip {si + 1}/{n_strips}")
    return int(np.asarray(best_dev))


def sw_affine_numpy_blocked(seq_a: bytes, seq_b: bytes,
                            gap_open: int = GAP_OPEN,
                            gap_extend: int = GAP_EXTEND) -> int:
    """Vectorized NumPy anti-diagonal Gotoh golden, O(M+N) memory."""
    a = np.frombuffer(seq_a, np.uint8).astype(np.int64)
    b = np.frombuffer(seq_b, np.uint8).astype(np.int64)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    NEG = np.int64(-(2**40))
    ph = np.zeros(M + 1, np.int64)   # H on diagonal d-1, index i+1
    ph2 = np.zeros(M + 1, np.int64)  # H on diagonal d-2
    pe = np.full(M + 1, NEG)         # E on diagonal d-1
    pf = np.full(M + 1, NEG)         # F on diagonal d-1
    best = 0
    for d in range(M + N - 1):
        lo = max(0, d - N + 1)
        hi = min(d, M - 1)
        i = np.arange(lo, hi + 1)
        s = np.where(a[i] == b[d - i], MATCH_SCORE, MISMATCH_PENALTY)
        e = np.maximum(pe[i], ph[i] + gap_open) + gap_extend       # (i-1, j)
        f = np.maximum(pf[i + 1], ph[i + 1] + gap_open) + gap_extend  # (i, j-1)
        h = np.maximum(np.maximum(ph2[i] + s, np.maximum(e, f)), 0)
        best = max(best, int(h.max()))
        ph2 = ph
        ph = np.zeros(M + 1, np.int64)
        ph[i + 1] = h
        ne = np.full(M + 1, NEG)
        ne[i + 1] = e
        nf = np.full(M + 1, NEG)
        nf[i + 1] = f
        pe, pf = ne, nf
    return best


def sw_affine_score_long_sharded(
    seq_a: bytes | np.ndarray,
    seq_b: bytes | np.ndarray,
    mesh,
    axis: str = "seq",
    gap_open: int = GAP_OPEN,
    gap_extend: int = GAP_EXTEND,
    width: int = DEFAULT_WIDTH,
    blk: int = DEFAULT_BLK,
    progress=None,
) -> int:
    """Affine (Gotoh) long-pair SW on a device mesh: the same pipelined
    row-band / halo-exchange structure as sw_score_long_sharded, with a
    5-array wavefront state (w, H-diag pair, E, F) and TWO carried boundary
    columns (H and F). The overlap re-sweep's garbage-boundary argument
    holds for F exactly as for H: a boundary value injected at step t only
    influences cells of rows >= t, and harvested rows precede them."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    a, b = _as_codes(seq_a), _as_codes(seq_b)
    M, N = a.size, b.size
    if M == 0 or N == 0:
        return 0
    C = int(mesh.shape[axis])
    W = strip_width(width, N)
    K = -(-N // W)
    T = -(-(M + W) // (C * blk)) * (C * blk)
    band = T // C
    if band < W:
        raise ValueError(
            f"band ({band} rows) must cover one strip width ({W}); "
            f"use fewer devices, a narrower strip, or longer sequences"
        )
    # each band re-sweeps the W - 1 rows past its end (the a-row halo)
    a_pad = np.full(T + W - 1, PAD_A, np.int32)
    a_pad[:M] = a
    a_bands = a_pad[:T].reshape(C, band)
    a_halo = np.stack([a_pad[(c + 1) * band: (c + 1) * band + W - 1]
                       for c in range(C)])
    shard = NamedSharding(mesh, P(axis))
    a_bands = jax.device_put(jnp.asarray(a_bands), shard)
    a_halo = jax.device_put(jnp.asarray(a_halo), shard)
    lch = jax.device_put(jnp.zeros((C, band), jnp.int32), shard)
    lcf = jax.device_put(jnp.full((C, band), _NEG_LONG, jnp.int32), shard)
    state = tuple(
        jax.device_put(jnp.zeros((C, W), jnp.int32), shard)
        for _ in range(5)
    )
    best_run = jax.device_put(jnp.zeros((C,), jnp.int32), shard)


    def stage_local(b_cols, a_band, a_hal, lch_in, lcf_in,
                    w0, d10, d1s0, e10, f10, flags, best_in):
        b_t = b_cols[0]
        first = flags[0, 0] != 0
        active = flags[0, 1] != 0
        chip = jax.lax.axis_index(axis)
        use_cold = (chip == 0) | ~active
        cw = w0[0] * 0 + int(PAD_A)
        cz = w0[0] * 0
        cn = w0[0] * 0 + _NEG_LONG
        st0 = (
            jnp.where(use_cold, cw, w0[0]),
            jnp.where(use_cold, cz, d10[0]),
            jnp.where(use_cold, cz, d1s0[0]),
            jnp.where(use_cold, cn, e10[0]),
            jnp.where(use_cold, cn, f10[0]),
        )
        lch_eff = jnp.where(first, 0, lch_in[0])
        lcf_eff = jnp.where(first, _NEG_LONG, lcf_in[0])
        best1, rch1, rcf1, st_t = _run_strip_affine(
            b_t, a_band[0], lch_eff, lcf_eff, gap_open, gap_extend,
            state=st0)
        best2, rch2, rcf2, _ = _run_strip_affine(
            b_t, a_hal[0], a_hal[0] * 0, a_hal[0] * 0 + _NEG_LONG,
            gap_open, gap_extend, state=st_t)
        lch_next = jnp.concatenate([rch1[W - 1:], rch2])
        lcf_next = jnp.concatenate([rcf1[W - 1:], rcf2])
        stage_best = jnp.maximum(best1, best2)
        best_out = jnp.maximum(best_in[0],
                               jnp.where(active, stage_best, 0))
        perm = [(i, i + 1) for i in range(C - 1)]
        nstate = tuple(
            jax.lax.ppermute(t[None], axis, perm) for t in st_t
        )
        return (lch_next[None], lcf_next[None]) + nstate + (best_out[None],)

    spec = P(axis)
    key = (mesh, axis, W, blk, band, gap_open, gap_extend, "affine")
    stage_fn = _SHARDED_STAGE_CACHE.get(key)
    if stage_fn is None:
        stage_fn = jax.jit(shard_map(
            stage_local, mesh=mesh,
            in_specs=(spec,) * 12, out_specs=(spec,) * 8,
            check_vma=False,
        ))
        _SHARDED_STAGE_CACHE[key] = stage_fn

    for s_i in range(K + C - 1):
        b_t, fl = _stage_inputs(b, s_i, C, K, W, shard)
        outs = stage_fn(b_t, a_bands, a_halo, lch, lcf, *state, fl,
                        best_run)
        lch, lcf = outs[0], outs[1]
        state = tuple(outs[2:7])
        best_run = outs[7]
        if progress:
            progress(f"  sw-affine-long-sharded stage {s_i + 1}/{K + C - 1}")
    return int(np.asarray(jnp.max(best_run)))
