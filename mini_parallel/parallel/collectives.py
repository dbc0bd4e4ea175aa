"""Collective merge helpers: the cross-device versions of the reference's
host-side accumulations.

Reference equivalents being replaced:
- ``total_score += score`` per chunk (`aligner.rs:276`)  -> psum over data axis
- ``atomic_max(result, ...)`` (`smith_waterman.cl:69`)   -> pmax over data axis
- k-mer histogram merge (reference never implemented it) -> psum of bucket
  counts
- long-sequence Kadane across shards                     -> all_gather of the
  4-tuple segment summaries + associative fold (the genomics analogue of a
  ring/blockwise scan: only O(4) scalars cross the interconnect per shard).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mini_parallel.ops.kadane import KadaneSummary, kadane_combine, kadane_summary


def merge_scores(total: jnp.ndarray, axis: str) -> jnp.ndarray:
    return jax.lax.psum(total, axis)


def merge_max(value: jnp.ndarray, axis: str) -> jnp.ndarray:
    return jax.lax.pmax(value, axis)


def merge_histogram(counts: jnp.ndarray, axis: str) -> jnp.ndarray:
    return jax.lax.psum(counts, axis)


def kadane_merge_over_axis(summ: KadaneSummary, axis: str) -> jnp.ndarray:
    """Merge per-shard Kadane summaries across a mesh axis, in shard order.

    Each device contributes its segment's (total, best, prefix, suffix);
    summaries are all-gathered (tiny — 4 scalars per batch element per shard)
    and folded left-to-right with the associative combiner. Returns the global
    ``best`` (same value on every shard).
    """
    gathered = jax.tree.map(
        lambda x: jax.lax.all_gather(x, axis, axis=0), summ
    )  # leaves: (n_shards, ...)
    n = gathered.total.shape[0]

    def body(i, acc):
        piece = jax.tree.map(lambda x: x[i], gathered)
        return kadane_combine(acc, piece)

    init = jax.tree.map(lambda x: x[0], gathered)
    out = jax.lax.fori_loop(1, n, body, init)
    # the fold yields the same value on every shard, but shard_map can't
    # statically prove that — a pmax (value no-op) marks it replicated
    return jax.lax.pmax(out.best, axis)


def sequence_parallel_kadane(scores: jnp.ndarray, valid: jnp.ndarray,
                             axis: str) -> jnp.ndarray:
    """Exact contiguous Kadane over a sequence sharded on ``axis``.

    ``scores``/``valid`` are the local (..., L_shard) slices, laid out so that
    shard i holds positions [i*L_shard, (i+1)*L_shard) — i.e. contiguous
    blocks in mesh order, which jax.sharding produces for a PartitionSpec on
    the last axis.
    """
    return kadane_merge_over_axis(kadane_summary(scores, valid), axis)
