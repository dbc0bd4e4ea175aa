"""Parity-mode "alignment" scoring: the reference kernel's exact semantics.

The reference's *live* kernel (`smith_waterman/src/smith_waterman.cl:11-71`,
the only one launched — `smith_waterman/src/aligner.rs:512`) is not
Smith-Waterman. It scores position-wise equality of ``seq1[i]`` vs ``seq2[i]``
(+2 match / -1 mismatch, `smith_waterman.cl:5-6`) and runs a Kadane
max-subarray (reset at 0, `smith_waterman.cl:50-51`) — but **per work item
over a strided subsequence**: the length is split into ``num_groups`` chunks
(`smith_waterman.cl:26-28`), and within a chunk work item ``lid`` visits
positions ``start+lid, start+lid+group_size, ...`` (`smith_waterman.cl:39`).
The final score is the max over all work items (local tree reduction
`smith_waterman.cl:60-65` + atomic_max `smith_waterman.cl:69`), floored at 0.

Host-side dispatch (`smith_waterman/src/aligner.rs:410-531`):
  - ``len = min(len1, len2)``; 0 -> score 0 (`aligner.rs:413-416`)
  - ``group_size = min(device_max_wg, 1024)`` (`aligner.rs:422`, `gpu.rs:9`)
  - ``num_groups = min(ceil(len/group_size), 1_000_000)`` (`aligner.rs:423-424`,
    `gpu.rs:10`)

Consequence: whenever ``len <= group_size * max_groups`` (always true in
practice — the memory guard at `aligner.rs:436-456` caps sequences far below
the 1.024e9 crossover), each work item sees **at most one** position, so the
Kadane run degenerates and the score is exactly::

    2 if any(seq1[i] == seq2[i] for i < len) else 0

Three implementations live here:

- :func:`reference_align_score` — bit-exact NumPy emulation of the general
  strided dispatch (any length), the golden for parity tests.
- :func:`kadane_score_batch` — the jitted device production path for the
  degenerate (realistic) regime, batched over read-chunks.
- :func:`kadane_contiguous_batch` / the segment monoid — the *contiguous*
  Kadane the reference plausibly intended, implemented as an associative scan
  so it shards across devices on a sequence axis (each shard computes a
  4-tuple summary, merged associatively across the mesh — see
  parallel/collectives.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MATCH_SCORE = 2  # smith_waterman.cl:5
MISMATCH_PENALTY = -1  # smith_waterman.cl:6
GAP_PENALTY = -2  # smith_waterman.cl:7 (unused by the live kernel)

WORK_GROUP_SIZE = 1024  # gpu.rs:9  (GPU_WORK_GROUP_SIZE)
MAX_WORK_GROUPS = 1_000_000  # gpu.rs:10 (GPU_MAX_WORK_GROUPS)

_NEG_INF = np.int32(-(10**9))


def _kadane_max(scores: np.ndarray) -> int:
    """max(0, max subarray sum) — smith_waterman.cl:50-51 per work item."""
    best = 0
    cur = 0
    for s in scores:
        cur = max(cur + int(s), 0)
        best = max(best, cur)
    return best


def reference_align_score(
    seq1: bytes | str | np.ndarray,
    seq2: bytes | str | np.ndarray,
    work_group_size: int = WORK_GROUP_SIZE,
    max_work_groups: int = MAX_WORK_GROUPS,
) -> int:
    """Bit-exact emulation of ``gpu_align`` (aligner.rs:410) + the live kernel.

    NumPy, host-only; used as the parity golden. Handles the general strided
    regime (arbitrarily long sequences), not just the degenerate case.
    """
    a = _as_u8(seq1)
    b = _as_u8(seq2)
    n = min(a.size, b.size)
    if n == 0:
        return 0  # aligner.rs:414-416
    scores = np.where(a[:n] == b[:n], MATCH_SCORE, MISMATCH_PENALTY).astype(np.int64)

    num_groups = min(-(-n // work_group_size), max_work_groups)
    chunk = -(-n // num_groups)  # smith_waterman.cl:26
    best = 0
    for g in range(num_groups):
        start = g * chunk
        end = min(start + chunk, n)  # smith_waterman.cl:27-28
        if start >= n:
            break
        for lid in range(work_group_size):
            idx = np.arange(start + lid, end, work_group_size)
            if idx.size == 0:
                continue
            best = max(best, _kadane_max(scores[idx]))
    return best


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.asarray(seq, dtype=np.uint8)


def degenerate_regime(length: int, work_group_size: int = WORK_GROUP_SIZE,
                      max_work_groups: int = MAX_WORK_GROUPS) -> bool:
    """True when every work item sees <=1 position (chunk <= group_size).

    Holds iff ceil(len/wgs) <= max_groups, i.e. len <= wgs*max_groups
    (1.024e9 with reference constants) — which the reference's own memory
    guard guarantees (aligner.rs:436-456).
    """
    return -(-length // work_group_size) <= max_work_groups


@functools.partial(jax.jit, static_argnames=("block",))
def kadane_score_batch(
    seq_a: jnp.ndarray,
    seq_b: jnp.ndarray,
    len_a: jnp.ndarray,
    len_b: jnp.ndarray,
    block: int | None = None,
) -> jnp.ndarray:
    """Batched parity score in the degenerate regime.

    Args:
      seq_a, seq_b: (B, L) uint8 (ASCII or codes — only equality matters;
        pads must be non-equal sentinels, see encode.PAD_A/PAD_B).
      len_a, len_b: (B,) int32 true lengths.

    Returns (B,) int32: 2 where any position i < min(len_a, len_b) matches,
    else 0 — exactly the reference score for realistic sequence sizes.
    """
    del block
    n = jnp.minimum(len_a, len_b)[:, None]  # aligner.rs:413
    pos = jnp.arange(seq_a.shape[1], dtype=jnp.int32)[None, :]
    hit = (seq_a == seq_b) & (pos < n)
    return jnp.where(jnp.any(hit, axis=1), MATCH_SCORE, 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Contiguous Kadane (the intended algorithm), as an associative monoid so it
# parallelizes within a chip (associative_scan) and across chips (shard
# summaries merged with the same combiner over a mesh axis).
# ---------------------------------------------------------------------------


class KadaneSummary(NamedTuple):
    """Segment summary for max-subarray: the classic 4-tuple monoid."""

    total: jnp.ndarray  # sum of segment
    best: jnp.ndarray  # best subarray sum within segment (>= 0 here)
    prefix: jnp.ndarray  # best prefix sum
    suffix: jnp.ndarray  # best suffix sum


def kadane_combine(l: KadaneSummary, r: KadaneSummary) -> KadaneSummary:
    """Associative merge of two adjacent segment summaries."""
    return KadaneSummary(
        total=l.total + r.total,
        best=jnp.maximum(jnp.maximum(l.best, r.best), l.suffix + r.prefix),
        prefix=jnp.maximum(l.prefix, l.total + r.prefix),
        suffix=jnp.maximum(r.suffix, r.total + l.suffix),
    )


def kadane_summary(scores: jnp.ndarray, valid: jnp.ndarray) -> KadaneSummary:
    """Summarize a (..., L) score segment; invalid positions contribute 0.

    Invalid (padded) positions are treated as score-0 elements, which leaves
    ``best`` unchanged (empty runs score 0 anyway) and keeps the monoid exact
    for ragged tails.
    """
    s = jnp.where(valid, scores, 0).astype(jnp.int32)
    total = jnp.sum(s, axis=-1)

    def step(carry, x):
        cur, best, pref, run = carry
        cur = jnp.maximum(cur + x, 0)
        best = jnp.maximum(best, cur)
        run = run + x
        pref = jnp.maximum(pref, run)
        return (cur, best, pref, run), None

    L = s.shape[-1]
    # derive the init from the data (not a fresh constant) so that under
    # shard_map the carry keeps the same varying-axis type as the operand
    zeros = s[..., 0] * 0
    (cur, best, pref, _run), _ = jax.lax.scan(
        step, (zeros, zeros, zeros, zeros), jnp.moveaxis(s, -1, 0), length=L
    )
    # suffix: best suffix sum = cur (Kadane's running value IS the max suffix
    # floored at 0; exact max-suffix needs no floor, recover via reverse scan)
    def rstep(carry, x):
        run, suf = carry
        run = run + x
        suf = jnp.maximum(suf, run)
        return (run, suf), None

    (_, suf), _ = jax.lax.scan(
        rstep, (zeros, zeros), jnp.moveaxis(s, -1, 0)[::-1], length=L
    )
    del cur
    return KadaneSummary(total=total, best=best, prefix=pref, suffix=suf)


def kadane_contiguous_batch(
    seq_a: jnp.ndarray, seq_b: jnp.ndarray, len_a: jnp.ndarray, len_b: jnp.ndarray
) -> jnp.ndarray:
    """True contiguous Kadane max-run score over position-wise +2/-1, batched.

    This is the score a *single* work item scanning the whole sequence would
    produce — the algorithm the reference kernel describes in its comments
    ("simplified Smith-Waterman", smith_waterman.cl:49) before the striding
    scatters it.
    """
    n = jnp.minimum(len_a, len_b)[:, None]
    pos = jnp.arange(seq_a.shape[1], dtype=jnp.int32)[None, :]
    valid = pos < n
    scores = jnp.where(seq_a == seq_b, MATCH_SCORE, MISMATCH_PENALTY)
    summ = kadane_summary(scores, valid)
    return summ.best.astype(jnp.int32)
