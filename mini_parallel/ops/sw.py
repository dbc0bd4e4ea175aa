"""True Smith-Waterman local alignment, batched on the accelerator.

The reference *advertises* Smith-Waterman (+2 match / -1 mismatch / -2 gap,
`smith_waterman/src/smith_waterman.cl:5-7`, `README.md:5`) but its live kernel
computes something else (see ops/kadane.py). This module is the real
capability: linear-gap local alignment DP

    H[i,j] = max(0, H[i-1,j-1] + s(a_i, b_j), H[i-1,j] + GAP, H[i,j-1] + GAP)
    score  = max_{i,j} H[i,j]

re-designed as an **anti-diagonal wavefront**: on diagonal ``d = i + j``
every cell depends only on diagonals ``d-1`` and ``d-2``, so a whole
diagonal updates as one vector op, and a batch of B independent alignments
vectorizes across the batch axis. The dead "detailed" kernel in the
reference (`smith_waterman.cl:74-152`) attempted a row-parallel version of
this DP; the wavefront formulation removes its intra-row race entirely.

Padding contract: pad ``a`` with encode.PAD_A and ``b`` with encode.PAD_B
(distinct sentinels). Pad positions always mismatch, and since every DP move
into a pad cell strictly decreases H (mismatch -1 or gap -2) while H >= 0
everywhere, the global max over the padded matrix equals the max over the
valid submatrix — so per-pair ragged lengths need no masking in the hot loop.

Layers:
  - :func:`sw_score_numpy` — O(mn) NumPy golden, used only in tests.
  - :func:`sw_score_batch` — pure-JAX ``lax.scan`` over diagonals, batched;
    the portable path and the correctness oracle for the CUDA kernel
    (ops/sw_gpu.py).
  - :func:`sw_vs_ref_batch` — reads against one shared reference, with the
    best cell's reference end (the exhaustive rescue mapper).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mini_parallel.ops.encode import PAD_B

MATCH_SCORE = 2  # smith_waterman.cl:5
MISMATCH_PENALTY = -1  # smith_waterman.cl:6
GAP_PENALTY = -2  # smith_waterman.cl:7


def sw_score_numpy(a, b, match=MATCH_SCORE, mismatch=MISMATCH_PENALTY,
                   gap=GAP_PENALTY) -> int:
    """Golden quadratic DP (host-only, tests)."""
    if isinstance(a, str):
        a = a.encode("ascii")
    if isinstance(b, str):
        b = b.encode("ascii")
    a = np.frombuffer(bytes(a), dtype=np.uint8)
    b = np.frombuffer(bytes(b), dtype=np.uint8)
    m, n = len(a), len(b)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, H[i - 1, j] + gap,
                          H[i, j - 1] + gap)
            best = max(best, H[i, j])
    return int(best)


@functools.partial(jax.jit, static_argnames=())
def sw_score_batch(seq_a: jnp.ndarray, seq_b: jnp.ndarray) -> jnp.ndarray:
    """Batched SW scores via anti-diagonal scan.

    Args:
      seq_a: (B, M) uint8, padded with encode.PAD_A past each true length.
      seq_b: (B, N) uint8, padded with encode.PAD_B.

    Returns:
      (B,) int32 local-alignment scores.

    The scan carries two diagonals of shape (B, M) in int32. The diagonal
    window of ``b`` is a contiguous reversed slice, so the per-step gather is
    a single ``dynamic_slice`` + reverse — no scatter/gather tables, which is
    what keeps this XLA-friendly.
    """
    B, M = seq_a.shape
    N = seq_b.shape[1]
    a = seq_a.astype(jnp.int32)
    # bp[k] = b[k - (M-1)]; window w[i] = b[d-i] = reverse(bp[d : d+M]).
    bp = jnp.concatenate(
        [
            jnp.full((B, M - 1), PAD_B, dtype=jnp.int32),
            seq_b.astype(jnp.int32),
            jnp.full((B, M), PAD_B, dtype=jnp.int32),
        ],
        axis=1,
    )

    def shift_down(x):  # x[i] -> x[i-1], zero boundary (H[-1, *] = 0)
        return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), x[:, :-1]], axis=1)

    def step(carry, d):
        d1, d2, best = carry  # D_{d-1}, D_{d-2}, running max
        w = jax.lax.dynamic_slice_in_dim(bp, d, M, axis=1)[:, ::-1]
        s = jnp.where(a == w, MATCH_SCORE, MISMATCH_PENALTY)
        cand = jnp.maximum(shift_down(d2) + s, 0)
        cand = jnp.maximum(cand, shift_down(d1) + GAP_PENALTY)
        cand = jnp.maximum(cand, d1 + GAP_PENALTY)
        best = jnp.maximum(best, jnp.max(cand, axis=1))
        return (cand, d1, best), None

    # derive inits from the operand so the carry keeps the same varying-axis
    # type under shard_map (a fresh constant would be "unvarying" and trip
    # scan's carry type check)
    z = a * 0
    (_, _, best), _ = jax.lax.scan(
        step, (z, z, a[:, 0] * 0), jnp.arange(M + N - 1)
    )
    return best


def sw_vs_ref_numpy(read, ref, match=MATCH_SCORE, mismatch=MISMATCH_PENALTY,
                    gap=GAP_PENALTY) -> tuple[int, int]:
    """Golden oracle for reads-vs-reference SW: (best score, ref_end).

    ref_end is the 0-based reference index (column) of the best-scoring DP
    cell, minimized over ties across ALL cells that achieve the maximum;
    -1 when the best score is 0 (no alignment).
    """
    import numpy as np

    if isinstance(read, str):
        read = read.encode("ascii")
    if isinstance(ref, str):
        ref = ref.encode("ascii")
    a = np.frombuffer(bytes(read), np.uint8)
    b = np.frombuffer(bytes(ref), np.uint8)
    m, n = len(a), len(b)
    H = np.zeros((m + 1, n + 1), np.int64)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i, j] = max(
                0, H[i - 1, j - 1] + s, H[i - 1, j] + gap, H[i, j - 1] + gap
            )
    best = int(H.max())
    if best <= 0:
        return 0, -1
    cells = np.nonzero(H == best)
    return best, int(cells[1].min()) - 1  # column j -> 0-based ref index


@jax.jit
def sw_vs_ref_batch(reads: jnp.ndarray,
                    ref: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exhaustive SW of every read against one shared reference sequence.

    Args: reads (B, M) uint8 padded with PAD_A; ref (N,) uint8. Returns
    (scores (B,) int32, ref_end (B,) int32): ref_end is the 0-based
    reference index of the best cell, the smallest among all cells that
    reach the best score, and -1 when the score is 0 — exactly
    :func:`sw_vs_ref_numpy`.

    Same anti-diagonal scan as :func:`sw_score_batch`; every read shares
    the reference window, and each diagonal's best cell is tracked with its
    column so the end position falls out without a second pass.
    """
    B, M = reads.shape
    N = ref.shape[0]
    a = reads.astype(jnp.int32)
    rp = jnp.concatenate([
        jnp.full((M - 1,), PAD_B, jnp.int32),
        ref.astype(jnp.int32),
        jnp.full((M,), PAD_B, jnp.int32),
    ])
    i_idx = jnp.arange(M, dtype=jnp.int32)[None, :]

    def shift_down(x):
        return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), x[:, :-1]],
                               axis=1)

    def step(carry, d):
        d1, d2, best, end = carry
        w = jax.lax.dynamic_slice_in_dim(rp, d, M)[::-1]
        s = jnp.where(a == w[None, :], MATCH_SCORE, MISMATCH_PENALTY)
        cand = jnp.maximum(shift_down(d2) + s, 0)
        cand = jnp.maximum(cand, shift_down(d1) + GAP_PENALTY)
        cand = jnp.maximum(cand, d1 + GAP_PENALTY)
        j = d - i_idx
        cand_v = jnp.where((j >= 0) & (j < N), cand, 0)
        row_best = jnp.max(cand_v, axis=1)
        # smallest column among this diagonal's best cells = largest row
        i_hi = jnp.max(jnp.where(cand_v == row_best[:, None], i_idx, -1),
                       axis=1)
        j_lo = d - i_hi
        end = jnp.where(row_best > best, j_lo,
                        jnp.where(row_best == best, jnp.minimum(end, j_lo),
                                  end))
        return (cand, d1, jnp.maximum(best, row_best), end), None

    z = a * 0
    zb = a[:, 0] * 0
    (_, _, best, end), _ = jax.lax.scan(
        step, (z, z, zb, zb + (1 << 30)), jnp.arange(M + N - 1), unroll=4)
    return best, jnp.where(best > 0, end, -1)


def sw_score_pair(a: str | bytes, b: str | bytes) -> int:
    """Convenience: single-pair SW score through the batched device path."""
    from mini_parallel.ops.encode import PAD_A, pad_batch

    arr_a, _ = pad_batch([a], pad_value=int(PAD_A))
    arr_b, _ = pad_batch([b], pad_value=int(PAD_B))
    return int(sw_score_batch(jnp.asarray(arr_a), jnp.asarray(arr_b))[0])


# ---------------------------------------------------------------------------
# Affine-gap local alignment (Gotoh). A gap of length L costs
# gap_open + L * gap_extend; with gap_open=0, gap_extend=GAP_PENALTY this
# reduces exactly to the linear-gap DP above. The reference has no affine
# mode — this is a capability extension expected of a complete alignment
# framework (and the scoring model real aligners default to).
# ---------------------------------------------------------------------------

GAP_OPEN = -2
GAP_EXTEND = -1


def sw_affine_numpy(a, b, match=MATCH_SCORE, mismatch=MISMATCH_PENALTY,
                    gap_open=GAP_OPEN, gap_extend=GAP_EXTEND) -> int:
    """Golden Gotoh DP (host-only, tests)."""
    if isinstance(a, str):
        a = a.encode("ascii")
    if isinstance(b, str):
        b = b.encode("ascii")
    a = np.frombuffer(bytes(a), dtype=np.uint8)
    b = np.frombuffer(bytes(b), dtype=np.uint8)
    m, n = len(a), len(b)
    NEG = -(10**9)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # gap in a (along j)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # gap in b (along i)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(E[i, j - 1], H[i, j - 1] + gap_open) + gap_extend
            F[i, j] = max(F[i - 1, j], H[i - 1, j] + gap_open) + gap_extend
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)


@functools.partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def sw_affine_batch(seq_a: jnp.ndarray, seq_b: jnp.ndarray,
                    gap_open: int = GAP_OPEN,
                    gap_extend: int = GAP_EXTEND) -> jnp.ndarray:
    """Batched affine-gap SW via anti-diagonal scan (same layout contract as
    sw_score_batch). Carries H_{d-1}, H_{d-2}, E_{d-1}, F_{d-1}."""
    B, M = seq_a.shape
    N = seq_b.shape[1]
    a = seq_a.astype(jnp.int32)
    NEG = jnp.int32(-(2**24))  # large-negative that can't overflow when added
    bp = jnp.concatenate(
        [
            jnp.full((B, M - 1), PAD_B, dtype=jnp.int32),
            seq_b.astype(jnp.int32),
            jnp.full((B, M), PAD_B, dtype=jnp.int32),
        ],
        axis=1,
    )

    def shift_down(x, fill):
        return jnp.concatenate(
            [jnp.full((B, 1), fill, jnp.int32), x[:, :-1]], axis=1
        )

    def step(carry, d):
        h1, h2, e1, f1, best = carry
        w = jax.lax.dynamic_slice_in_dim(bp, d, M, axis=1)[:, ::-1]
        s = jnp.where(a == w, MATCH_SCORE, MISMATCH_PENALTY)
        e = jnp.maximum(e1, h1 + gap_open) + gap_extend
        f = jnp.maximum(shift_down(f1, NEG), shift_down(h1, 0) + gap_open) + gap_extend
        h = jnp.maximum(jnp.maximum(shift_down(h2, 0) + s, 0), jnp.maximum(e, f))
        best = jnp.maximum(best, jnp.max(h, axis=1))
        return (h, h1, e, f, best), None

    # operand-derived inits keep the carry's varying-axis type under shard_map
    z = a * 0
    neg = z + NEG
    (_, _, _, _, best), _ = jax.lax.scan(
        step, (z, z, neg, neg, a[:, 0] * 0),
        jnp.arange(M + N - 1),
    )
    return best
