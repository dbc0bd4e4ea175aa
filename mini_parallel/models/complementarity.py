"""Direct + complementary lane-pair alignment: % non-complementary metric.

The reference README's stated WGS goal (`README.md:14-16`):
  "Direct alignment: compare to average reference genome
   Complementary alignment: find what % of genome is not perfectly
   complementary (boooo)"
and BASELINE.json config 4: "Direct + complementary whole-lane alignment:
% non-complementary metric on SAMPLE_L001_R1/R2". The reference ships no
implementation; this is the real one.

For each mate pair (r1[i], r2[i]) of an R1/R2 lane pair:
- direct score  = alignment(r1, r2)           (mode: sw or parity kadane)
- comp score    = SW(r1, revcomp(r2))
- the pair is "perfectly complementary" iff comp score == 2 * min(len) —
  i.e. r1 aligns end-to-end against the reverse complement of r2 with all
  matches (the expected geometry of proper FR mate pairs).

%% non-complementary = 1 - perfect_pairs / total_pairs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

import functools

import jax

from mini_parallel.io import fastq
from mini_parallel.ops import encode, kadane
from mini_parallel.ops import packed as packedmod
from mini_parallel.ops.sw_gpu import sw_score_batch_best
from mini_parallel.utils.config import Config


@dataclass
class ComplementarityResult:
    file1: str
    file2: str
    pairs: int = 0
    direct_score_sum: int = 0
    comp_score_sum: int = 0
    perfect_pairs: int = 0
    seconds: float = 0.0
    # reads with no mate (unequal R1/R2 lane sizes — a data-integrity
    # signal, e.g. a truncated download); excluded from the pair metrics
    unpaired_reads: int = 0

    @property
    def pct_non_complementary(self) -> float:
        if self.pairs == 0:
            return 0.0
        return 100.0 * (1.0 - self.perfect_pairs / self.pairs)


def _revcomp_batch(reads: list[bytes]) -> list[bytes]:
    table = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
    return [r.translate(table)[::-1] for r in reads]


@functools.partial(jax.jit, static_argnames=("mode",))
def _pair_scores(a, b, len1, len2, mode: str):
    """(direct, comp, perfect) per pair; revcomp computed on-device."""
    if mode == "sw":
        direct = sw_score_batch_best(a, b)
    else:
        direct = kadane.kadane_score_batch(a, b, len1, len2)
    rc = encode.revcomp_padded(b, len2, int(encode.PAD_B))
    comp = sw_score_batch_best(a, rc)
    minlen = jnp.minimum(len1, len2)
    perfect = (comp == 2 * minlen) & (minlen > 0)
    return direct, comp, perfect


@functools.partial(jax.jit, static_argnames=("mode",))
def _pair_stats_packed(pk1, ec1, ev1, ln1, pk2, ec2, ev2, ln2, mode: str):
    """Scalar batch stats over 2-bit packed operands: only 3 ints return to
    the host per batch instead of three (B,) arrays."""
    a = packedmod.unpack_device(pk1, ec1, ev1, ln1, int(encode.PAD_A))
    b = packedmod.unpack_device(pk2, ec2, ev2, ln2, int(encode.PAD_B))
    direct, comp, perfect = _pair_scores(a, b, ln1, ln2, mode)
    return (direct.sum(), comp.sum(), perfect.sum(dtype=jnp.int32))


class ComplementarityEngine:
    def __init__(self, cfg: Config | None = None, mode: str = "sw",
                 mesh=None):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        self.mode = mode
        # optional device mesh: mate batches shard data-parallel with
        # psum-merged scalar stats (same pattern as AlignmentEngine)
        self.mesh = mesh
        self._sharded_fn = None

    def _pair_stats_sharded(self):
        if self._sharded_fn is not None:
            return self._sharded_fn
        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        axis = self.mesh.axis_names[0]
        mode = self.mode

        def local(pk1, ec1, ev1, ln1, pk2, ec2, ev2, ln2):
            d, c, p = _pair_stats_packed(pk1, ec1, ev1, ln1,
                                         pk2, ec2, ev2, ln2, mode)
            return (jax.lax.psum(d, axis), jax.lax.psum(c, axis),
                    jax.lax.psum(p, axis))

        self._sharded_fn = jax.jit(
            shard_map(
                local,
                mesh=self.mesh,
                check_vma=False,
                in_specs=(P(axis, None), P(axis, None), P(axis, None),
                          P(axis)) * 2,
                out_specs=(P(), P(), P()),
            )
        )
        return self._sharded_fn

    def _put_packed(self, pb):
        return packedmod.put_sharded(pb, self.mesh)

    def _pad_for_len(self, maxlen: int) -> int:
        """The one bucket rule for both the list and flat ingestion paths."""
        return -(-max(self.cfg.read_pad, maxlen) // 8) * 8

    def _pad_for(self, r1: list[bytes], r2: list[bytes]) -> int:
        return self._pad_for_len(max(
            max((len(r) for r in r1), default=1),
            max((len(r) for r in r2), default=1),
        ))

    def score_pairs_batch(self, r1: list[bytes], r2: list[bytes]):
        """(direct_scores, comp_scores, perfect_mask) for one mate batch."""
        pad = self._pad_for(r1, r2)
        arr1, len1 = encode.pad_batch(r1, pad_to=pad, pad_value=int(encode.PAD_A))
        arr2, len2 = encode.pad_batch(r2, pad_to=pad, pad_value=int(encode.PAD_B))
        direct, comp, perfect = _pair_scores(
            jnp.asarray(arr1), jnp.asarray(arr2),
            jnp.asarray(len1), jnp.asarray(len2), self.mode,
        )
        return np.asarray(direct), np.asarray(comp), np.asarray(perfect)

    def _batch_stats(self, r1: list[bytes], r2: list[bytes]):
        """Deferred device scalars (direct_sum, comp_sum, perfect_count)."""
        pad = self._pad_for(r1, r2)
        arr1, len1 = encode.pad_batch(r1, pad_to=pad, pad_value=int(encode.PAD_A))
        arr2, len2 = encode.pad_batch(r2, pad_to=pad, pad_value=int(encode.PAD_B))
        return self._stats_prepped(arr1, len1, arr2, len2, pad)

    def _flat_stats(self, f1, o1, f2, o2, n: int):
        """_batch_stats over the first n reads of two flat chunks — no
        per-read Python objects (io.fastq.iter_flat_chunks wire format)."""
        o1, o2 = o1[: n + 1], o2[: n + 1]
        m1 = int(np.diff(o1).max()) if n else 1
        m2 = int(np.diff(o2).max()) if n else 1
        pad = self._pad_for_len(max(m1, m2))
        arr1, len1 = encode.pad_batch_flat(
            f1[: int(o1[-1])], o1, pad_to=pad, pad_value=int(encode.PAD_A))
        arr2, len2 = encode.pad_batch_flat(
            f2[: int(o2[-1])], o2, pad_to=pad, pad_value=int(encode.PAD_B))
        return self._stats_prepped(arr1, len1, arr2, len2, pad)

    def _stats_prepped(self, arr1, len1, arr2, len2, pad: int):
        if self.cfg.packed_transfer and pad % 4 == 0:
            p1 = packedmod.pack_batch(arr1, len1)
            p2 = packedmod.pack_batch(arr2, len2)
            if self.mesh is not None:
                n = self.mesh.devices.size
                Bp = -(-p1.batch // n) * n
                # pad pairs score 0 / non-perfect by the sentinel contract
                return self._pair_stats_sharded()(
                    *self._put_packed(packedmod.pad_rows(p1, Bp)),
                    *self._put_packed(packedmod.pad_rows(p2, Bp)),
                )
            return _pair_stats_packed(
                *packedmod.device_args(p1), *packedmod.device_args(p2),
                mode=self.mode,
            )
        direct, comp, perfect = _pair_scores(
            jnp.asarray(arr1), jnp.asarray(arr2),
            jnp.asarray(len1), jnp.asarray(len2), self.mode,
        )
        return direct.sum(), comp.sum(), perfect.sum(dtype=jnp.int32)

    def analyze_lane_pair(self, file1: str, file2: str, progress=None
                          ) -> ComplementarityResult:
        res = ComplementarityResult(file1=file1, file2=file2)
        t0 = time.perf_counter()
        from itertools import zip_longest

        _empty = (np.empty(0, np.uint8), np.zeros(1, np.int64))
        it1 = fastq.prefetch(fastq.iter_flat_chunks(
            file1, self.cfg.chunk_size_reads))
        it2 = fastq.prefetch(fastq.iter_flat_chunks(
            file2, self.cfg.chunk_size_reads))
        deferred: list = []  # (n, direct_sum, comp_sum, perfect) device scalars
        for (f1, o1), (f2, o2) in zip_longest(it1, it2, fillvalue=_empty):
            n1, n2 = len(o1) - 1, len(o2) - 1
            n = min(n1, n2)
            res.unpaired_reads += max(n1, n2) - n
            if n == 0:
                continue
            stats = self._flat_stats(f1, o1, f2, o2, n)
            deferred.append((n, stats))
            res.pairs += n
            if progress:
                progress(f"  {res.pairs} pairs queued")
        if res.unpaired_reads and progress:
            progress(f"  WARNING: {res.unpaired_reads} unpaired reads "
                     f"(unequal lane sizes) excluded from pair metrics")
        # single drain: host decode overlapped the queued device work above;
        # one device_get fetches every batch's 3 scalars together (per-scalar
        # np.asarray would pay a host<->device round trip each)
        for _n, (d, c, p) in jax.device_get(deferred):
            res.direct_score_sum += int(d)
            res.comp_score_sum += int(c)
            res.perfect_pairs += int(p)
        res.seconds = time.perf_counter() - t0
        return res
