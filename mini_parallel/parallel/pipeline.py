"""The sharded WGS step: one jitted multi-chip program per batch of reads.

This is the framework's "training step" analogue — the unit the driver
dry-runs over an N-device mesh. One call consumes a (B, L) read batch sharded
over the ``data`` axis and produces globally-merged scalars:

- parity alignment score sum (reference --full-wgs accounting),
- true-SW score sum + global max (mate-pair r1 x r2 alignment),
- complementarity stats (README.md:15-16: % of pairs not perfectly
  complementary),
- a base-composition histogram, and
- a bucketed k=21-mer histogram (the all-reduce-merged k-mer summary from
  the north star; exact counts live in models/kmer_model.py),

all merged with psum/pmax. A separate sequence-parallel entry scores
one long sequence sharded over the ``seq`` axis via the Kadane monoid.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mini_parallel.ops import encode, kadane, sw
from mini_parallel.ops import packed as packedmod
from mini_parallel.ops.sw_gpu import sw_score_batch_best
from mini_parallel.parallel.mesh import DATA_AXIS, SEQ_AXIS
from mini_parallel.parallel import collectives


KMER_HIST_K = 21
KMER_HIST_BUCKETS = 4096  # power of two


def _kmer_bucket_hist(codes, lengths, k: int = KMER_HIST_K,
                      buckets: int = KMER_HIST_BUCKETS):
    """Bucketed k-mer histogram: every valid k-window hashed into a fixed
    number of buckets — a psum-mergeable k-mer composition summary. Exact
    counting is the KmerEngine's job; this is the cross-shard collective
    statistic (all-reduced across devices and hosts like the reference's
    score merges would have been, had it had any)."""
    from mini_parallel.ops import kmer as kmer_ops

    if codes.shape[1] < k:
        return jnp.zeros((buckets,), jnp.int32)
    hi, lo, ok = kmer_ops.pack_kmers(codes, lengths, k=k)
    mix = hi * jnp.int32(-1640531527) + lo  # Knuth multiplicative hash, wraps
    b = jnp.where(ok, mix & jnp.int32(buckets - 1), buckets)
    return jax.ops.segment_sum(
        ok.astype(jnp.int32).reshape(-1), b.reshape(-1),
        num_segments=buckets + 1,
    )[:buckets]


def _local_wgs_step(reads_a, reads_b, len_a, len_b, data_axis):
    parity = kadane.kadane_score_batch(reads_a, reads_b, len_a, len_b)
    sw_scores = sw_score_batch_best(reads_a, reads_b)

    # complementarity: r1 vs revcomp(r2); perfectly complementary pairs
    # align end-to-end with all matches => SW == 2*min(len)
    rc_b = encode.revcomp_padded(reads_b, len_b, int(encode.PAD_B))
    comp_scores = sw_score_batch_best(reads_a, rc_b)
    minlen = jnp.minimum(len_a, len_b)
    valid_pair = minlen > 0
    perfect = (comp_scores == 2 * minlen) & valid_pair

    # base-composition histogram over valid positions of reads_a
    codes = encode.ascii_to_code(reads_a)
    pos = jnp.arange(reads_a.shape[1], dtype=jnp.int32)[None, :]
    vmask = pos < len_a[:, None]
    one_hot = (codes[..., None] == jnp.arange(5)[None, None, :]) & vmask[..., None]
    hist = one_hot.sum(axis=(0, 1), dtype=jnp.int32)

    # bucketed k-mer (k=21) histogram of reads_a, psum-merged across shards —
    # the collective-mergeable summary the north star asks for (exact counts
    # stay on the KmerEngine + native store path, models/kmer_model.py)
    khist = _kmer_bucket_hist(codes, len_a)

    stats = {
        "parity_score": collectives.merge_scores(parity.sum(), data_axis),
        "sw_score_sum": collectives.merge_scores(sw_scores.sum(), data_axis),
        "sw_score_max": collectives.merge_max(sw_scores.max(), data_axis),
        "pairs": collectives.merge_scores(valid_pair.sum(dtype=jnp.int32), data_axis),
        "complementary_pairs": collectives.merge_scores(
            perfect.sum(dtype=jnp.int32), data_axis
        ),
        "base_hist": collectives.merge_histogram(hist, data_axis),
        "kmer_hist": collectives.merge_histogram(khist, data_axis),
        "bases": collectives.merge_scores(len_a.sum(), data_axis),
    }
    return stats



def make_wgs_step(mesh: Mesh, data_axis: str = DATA_AXIS):
    """Build the jitted sharded step: (reads_a, reads_b, len_a, len_b) -> stats.

    Inputs are (B, L) uint8 + (B,) int32, B divisible by the data-axis size.
    reads_a must be padded with encode.PAD_A, reads_b with encode.PAD_B.
    """

    def local_step(reads_a, reads_b, len_a, len_b):
        return _local_wgs_step(reads_a, reads_b, len_a, len_b, data_axis)

    spec2 = P(data_axis, None)
    spec1 = P(data_axis)
    rep = P()
    # check_vma=False: the FFI kernel's out_shape carries no varying-axis
    # metadata, which the vma checker (rightly) refuses to guess
    sharded = shard_map(
        local_step,
        mesh=mesh,
        check_vma=False,
        in_specs=(spec2, spec2, spec1, spec1),
        out_specs={
            "parity_score": rep, "sw_score_sum": rep, "sw_score_max": rep,
            "pairs": rep, "complementary_pairs": rep,
            "base_hist": rep, "kmer_hist": rep, "bases": rep,
        },
    )
    return jax.jit(sharded)


def make_wgs_step_packed(mesh: Mesh, data_axis: str = DATA_AXIS):
    """The sharded WGS step over 2-bit packed inputs (ops/packed.py).

    Same stats as make_wgs_step, but each operand crosses the host->device
    wire as (packed, exc_col, exc_val, lengths) — 4x fewer bytes — and is
    unpacked per-shard on the device, where XLA fuses the unpack into the
    consumers. Call as step(*device_args(pa), *device_args(pb)).
    """

    def local_step(pk_a, ec_a, ev_a, ln_a, pk_b, ec_b, ev_b, ln_b):
        reads_a = packedmod.unpack_device(pk_a, ec_a, ev_a, ln_a, int(encode.PAD_A))
        reads_b = packedmod.unpack_device(pk_b, ec_b, ev_b, ln_b, int(encode.PAD_B))
        return _local_wgs_step(reads_a, reads_b, ln_a, ln_b, data_axis)

    spec2 = P(data_axis, None)
    spec1 = P(data_axis)
    rep = P()
    sharded = shard_map(
        local_step,
        mesh=mesh,
        check_vma=False,
        in_specs=(spec2, spec2, spec2, spec1) * 2,
        out_specs={
            "parity_score": rep, "sw_score_sum": rep, "sw_score_max": rep,
            "pairs": rep, "complementary_pairs": rep,
            "base_hist": rep, "kmer_hist": rep, "bases": rep,
        },
    )
    return jax.jit(sharded)


def make_seq_parallel_kadane(mesh: Mesh, seq_axis: str = SEQ_AXIS):
    """Exact contiguous Kadane over a (B, L) score matrix sharded on L.

    The long-sequence path: L is split into contiguous blocks across the seq
    axis; each shard summarizes locally and 4 scalars/row cross the wire.
    """

    def local(scores, valid):
        return collectives.sequence_parallel_kadane(scores, valid, seq_axis)

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, seq_axis), P(None, seq_axis)),
        out_specs=P(),
    )
    return jax.jit(sharded)


def shard_batch(mesh: Mesh, arrays, data_axis: str = DATA_AXIS):
    """Place host arrays onto the mesh with (data, ...) sharding."""
    out = []
    for a in arrays:
        spec = P(data_axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
