"""k-mer counting pipeline: FASTQ file -> exact k-mer counts.

The real implementation of the reference's empty ``k_mer/`` workload
(`k_mer/kmer.txt:1`), per BASELINE.json config 3: "k-mer counting (k=21) over
one FASTQ lane with exact count parity".

Transfer discipline (the pipeline is wire-bound, not compute-bound):
- host->device: reads ship 2-bit packed (ops/packed.py), 4x fewer bytes;
- device->host: unique keys are compacted to the front of the sorted output
  (ops/kmer.py), so only the [0, n_unique) prefix is fetched — bucketed to a
  power of two to keep the fetch-program cache warm;
- the cross-batch aggregate lives in HBM by default
  (ops/kmer.py:DeviceKmerAccumulator — staged appends + sorted merges, one
  drain at file end, host spill above capacity); the native C++ hash store
  (native/kmer_store.cpp) serves mesh runs and spills, surfaced as NumPy
  arrays, never a 10M+ entry Python dict.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from mini_parallel.io import fastq
from mini_parallel.ops import encode, kmer
from mini_parallel.ops import packed as packedmod
from mini_parallel.utils.config import Config


@dataclass
class KmerResult:
    file_path: str
    k: int
    canonical: bool
    total_kmers: int = 0
    distinct_kmers: int = 0
    total_reads: int = 0
    seconds: float = 0.0
    # (hi, lo, count) int32/int32/uint64 NumPy arrays of the distinct k-mers
    # (empty in summary mode — the table never left the device)
    arrays: tuple = ()
    # summary-mode payload (see DeviceKmerAccumulator.summary):
    # multiplicity histogram (hist[c-1] = distinct k-mers seen c times,
    # last bin = tail) and the top-N (hi, lo, count) triples
    count_histogram: np.ndarray | None = None
    top_items: list = field(default_factory=list)

    def _require_full(self, what: str) -> None:
        if not self.arrays and self.distinct_kmers > 0:
            raise ValueError(
                f"{what} needs the full count table, but this result is "
                f"summary-mode (the table never left the device); re-run "
                f"with result_mode='full' (CLI: --kmer-out)"
            )

    @property
    def counts(self) -> dict:
        """(hi, lo) -> count dict. O(distinct): use .arrays for large runs."""
        self._require_full("counts")
        if not self.arrays:
            return {}
        hi, lo, ct = self.arrays
        return {
            (int(hi[i]), int(lo[i])): int(ct[i]) for i in range(hi.size)
        }

    def top(self, n: int = 10) -> list[tuple[str, int]]:
        if not self.arrays:
            if n > len(self.top_items) and self.distinct_kmers > len(
                    self.top_items):
                raise ValueError(
                    f"summary mode kept only the top {len(self.top_items)} "
                    f"k-mers; re-run with count_file(..., summary_top_n>="
                    f"{n}) or result_mode='full' for top({n})"
                )
            return [
                (kmer.key_to_string(h, l, self.k), c)
                for h, l, c in self.top_items[:n]
            ]
        hi, lo, ct = self.arrays
        order = np.lexsort((lo, hi, -ct.astype(np.int64)))[:n]
        return [
            (kmer.key_to_string(int(hi[i]), int(lo[i]), self.k), int(ct[i]))
            for i in order
        ]

    def histogram(self, bins: int = 64) -> np.ndarray:
        """Multiplicity histogram: out[c-1] = distinct k-mers with count c
        (c < bins), out[bins-1] = tail. Uses the device-side summary when
        present, else derives from .arrays. A summary-mode histogram can
        be re-binned DOWN exactly (tail absorbs folded bins) but never UP:
        the stored tail cannot be un-aggregated into exact bins."""
        if self.count_histogram is not None:
            h = self.count_histogram
            if h.size == bins:
                return h.copy()  # never hand out the stored array
            if bins > h.size:
                raise ValueError(
                    f"summary kept {h.size} bins; cannot expand to {bins} "
                    f"(tail bin is aggregated) — use result_mode='full'"
                )
            out = np.zeros(bins, np.int64)
            out[: bins - 1] = h[: bins - 1]
            out[bins - 1] = int(h[bins - 1:].sum())
            return out
        out = np.zeros(bins, np.int64)
        if self.arrays:
            ct = np.minimum(self.arrays[2].astype(np.int64), bins)
            out[:] = np.bincount(ct, minlength=bins + 1)[1:bins + 1]
        return out

    def write_counts(self, path: str) -> int:
        """Dump every distinct k-mer as "<kmer>\\t<count>" lines, sorted by
        key (gzip when path ends in .gz) — the Jellyfish-style dump format
        downstream tools consume. Returns the number of records written."""
        import gzip

        self._require_full("write_counts")
        opener = gzip.open if path.endswith(".gz") else open
        if not self.arrays:
            # a .gz path must still be a valid (empty) gzip member, not 0 bytes
            tmp = path + ".tmp"
            with opener(tmp, "wt"):
                pass
            os.replace(tmp, path)
            return 0
        hi, lo, ct = self.arrays
        order = np.lexsort((lo, hi))
        tmp = path + ".tmp"
        with opener(tmp, "wt") as f:
            for i in order:
                f.write(f"{kmer.key_to_string(int(hi[i]), int(lo[i]), self.k)}"
                        f"\t{int(ct[i])}\n")
        os.replace(tmp, path)
        return int(hi.size)


def _fetch_bucket(n: int, cap: int) -> int:
    """Power-of-two fetch size >= n (bounds the fetch-slice compile count)."""
    b = 1 << 10
    while b < n:
        b <<= 1
    return min(b, cap)


# sorted-triple fold helpers live in ops/kmer.py (the accumulator's spill
# path folds with them); re-exported here for existing importers/tests
from mini_parallel.ops.kmer import (  # noqa: E402,F401
    _EMPTY_ARRAYS,
    _combined_keys,
    _keys_if_sorted_unique,
    merge_sorted_arrays,
)


def save_kmer_checkpoint(path: str, arrays: tuple, meta: dict) -> None:
    """Atomic .npz snapshot: the merged counts so far + resume metadata."""
    import json

    tmp = path + ".tmp.npz"
    np.savez(tmp, hi=arrays[0], lo=arrays[1], ct=arrays[2],
             meta=np.array(json.dumps(meta)))
    import os

    os.replace(tmp, path)


def load_kmer_checkpoint(path: str):
    """-> ((hi, lo, ct), meta) or None when no checkpoint exists."""
    import json
    import os

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        arrays = (z["hi"].astype(np.int32), z["lo"].astype(np.int32),
                  z["ct"].astype(np.int64))
        meta = json.loads(str(z["meta"]))
    return arrays, meta


BYTES_PER_SLOT = 512  # store (12 B) + sorted-merge temporaries + staging
MIN_CAPACITY = 1 << 20


def capacity_for(bytes_limit: int | None) -> int:
    """Accumulator slots for a device that can hold ``bytes_limit`` bytes:
    the largest power of two at or under bytes_limit / BYTES_PER_SLOT, and
    never under MIN_CAPACITY (also the answer when the runtime reports no
    limit). Past capacity the accumulator spills to host merges, so this
    only decides how much of the sample stays on the device."""
    cap = MIN_CAPACITY
    if bytes_limit:
        while cap * 2 * BYTES_PER_SLOT <= bytes_limit:
            cap *= 2
    return cap


def _device_bytes_limit() -> int | None:
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("bytes_limit")


class KmerEngine:
    def __init__(self, cfg: Config | None = None, k: int = kmer.DEFAULT_K,
                 canonical: bool = False, mesh=None,
                 device_accumulate: bool = True,
                 device_capacity: int | None = None):
        self.cfg = cfg or Config(chunk_size_reads=10_000)
        self.k = k
        self.canonical = canonical
        # device-resident accumulator (ops/kmer.py:DeviceKmerAccumulator):
        # cross-batch aggregate stays in HBM, zero D2H until the final
        # drain. Used on the single-device packed path; host-store merge
        # remains for meshes and as the spill target.
        self.device_accumulate = device_accumulate
        self.device_capacity = device_capacity
        # optional device mesh: read batches shard data-parallel; each shard
        # sort/dedups locally and the host store merges the per-shard
        # (keys, counts) — exact counts, no cross-chip collective needed
        # (the psum-merged bucketed histogram lives in parallel/pipeline.py)
        self.mesh = mesh
        self._sharded_fn = None
        self._store_factory = None
        try:
            from mini_parallel.native import available, kmer_store

            if available():
                self._store_factory = kmer_store.KmerStore
        except Exception:  # native plane not built: Python dict fallback
            pass

    def _sharded_counts(self):
        """shard_map k-mer counter: per-shard compacted uniques, stacked."""
        if self._sharded_fn is not None:
            return self._sharded_fn
        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        axis = self.mesh.axis_names[0]
        k, canonical = self.k, self.canonical

        def local(pk, ec, ev, ln):
            hi, lo, counts, nu = kmer.unique_counts_packed(
                pk, ec, ev, ln, k=k, canonical=canonical
            )
            # one leading shard axis so P(axis) stacking keeps per-shard
            # compaction boundaries addressable on host
            return (hi[None], lo[None], counts[None], nu[None])

        self._sharded_fn = jax.jit(
            shard_map(
                local,
                mesh=self.mesh,
                check_vma=False,
                in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
                out_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
            )
        )
        return self._sharded_fn

    def make_store(self):
        """Native hash store when built, else a plain dict."""
        if self._store_factory:
            # start at 4M slots: saves ~8 early full-table rehashes on
            # WGS-scale runs (the table doubles toward 10^7+ distinct keys)
            return self._store_factory(initial_capacity=1 << 22)
        return {}

    def _pad_for(self, maxlen: int) -> int:
        pad = max(self.cfg.read_pad, self.k + 7, maxlen)
        return -(-pad // 8) * 8

    def count_reads_batch(self, reads: list[bytes], agg) -> tuple[int, int]:
        """Count one batch on device, merge into ``agg``. Returns
        (n_kmers_in_batch, n_reads)."""
        pad = self._pad_for(max((len(r) for r in reads), default=1))
        arr, lens = encode.pad_batch(reads, pad_to=pad, pad_value=int(encode.PAD_A))
        return self._count_arr_batch(arr, lens, pad, agg)

    def _count_arr_batch(self, arr, lens, pad, agg) -> tuple[int, int]:
        if self.mesh is not None and self.cfg.packed_transfer and pad % 4 == 0:
            return self._count_batch_sharded(arr, lens, agg)
        if self.cfg.packed_transfer and pad % 4 == 0:
            pb = packedmod.pack_batch(arr, lens)
            hi, lo, counts, nu = kmer.unique_counts_packed(
                *packedmod.device_args(pb), k=self.k, canonical=self.canonical
            )
        else:
            codes = encode.ascii_to_code(jnp.asarray(arr))
            hi, lo, counts, nu = kmer.unique_counts_batch(
                codes, jnp.asarray(lens), k=self.k, canonical=self.canonical
            )
        # fetch only the unique prefix (keys are compacted to the front)
        nu = int(nu)
        m = _fetch_bucket(nu, hi.shape[0])
        hi = np.asarray(hi[:m])[:nu]
        lo = np.asarray(lo[:m])[:nu]
        counts = np.asarray(counts[:m])[:nu]
        if isinstance(agg, dict):
            kmer.merge_device_counts(agg, hi, lo, counts)
        else:  # native KmerStore: bulk merge in C++
            agg.merge(hi, lo, counts)
        return int(counts.sum()), arr.shape[0]

    def _count_batch_sharded(self, arr, lens, agg) -> tuple[int, int]:
        """Sharded batch count: each shard compacts its uniques; the host
        store merges every shard's bucketed unique prefix (fetching the full
        slabs would ship B*W entries per shard — the prefix discipline from
        the single-device path applies per shard here)."""
        n = self.mesh.devices.size
        B = arr.shape[0]
        pb = packedmod.pad_rows(packedmod.pack_batch(arr, lens),
                                -(-B // n) * n)
        hi, lo, counts, nu = self._sharded_counts()(
            *packedmod.put_sharded(pb, self.mesh)
        )
        nu = np.asarray(nu)  # one small fetch for all shards' unique counts
        total = 0
        # per-shard prefix fetch: each shard's row lives on one device;
        # addressable_shards slices it there without cross-device gathers
        for sh_h, sh_l, sh_c in zip(hi.addressable_shards,
                                    lo.addressable_shards,
                                    counts.addressable_shards):
            s = sh_h.index[0].start or 0
            m = int(nu[s])
            if not m:
                continue
            mb = _fetch_bucket(m, sh_h.data.shape[1])
            h = np.asarray(sh_h.data[0, :mb])[:m]
            l = np.asarray(sh_l.data[0, :mb])[:m]
            c = np.asarray(sh_c.data[0, :mb])[:m]
            total += int(c.sum())
            if isinstance(agg, dict):
                kmer.merge_device_counts(agg, h, l, c)
            else:
                agg.merge(h, l, c)
        return total, B

    def _use_device_acc(self) -> bool:
        return (self.device_accumulate and self.mesh is None
                and self.cfg.packed_transfer)

    def _checkpoint_meta(self, path: str, res: KmerResult,
                         chunks_done: int) -> dict:
        return {
            "file_path": path, "k": self.k, "canonical": self.canonical,
            "chunk_size_reads": self.cfg.chunk_size_reads,
            "chunks_done": chunks_done, "total_reads": res.total_reads,
            "total_kmers": res.total_kmers,
        }

    @staticmethod
    def _agg_arrays(agg) -> tuple:
        """(hi, lo, ct) triple of a host store's current contents."""
        if isinstance(agg, dict):
            hi = np.fromiter((k[0] for k in agg), np.int32, len(agg))
            lo = np.fromiter((k[1] for k in agg), np.int32, len(agg))
            ct = np.fromiter(agg.values(), np.int64, len(agg))
            return hi, lo, ct
        return agg.items_arrays()

    def _load_resume(self, checkpoint_path: str | None, res: KmerResult,
                     file_path: str | None = None):
        """-> (base arrays, start_chunk); validates the checkpoint matches
        this engine's parameters AND the input file (resuming a different
        FASTQ — or different k / canonical / chunk size — would silently
        corrupt counts)."""
        base, start_chunk = _EMPTY_ARRAYS, 0
        if not checkpoint_path:
            return base, start_chunk
        loaded = load_kmer_checkpoint(checkpoint_path)
        if loaded is None:
            return base, start_chunk
        base, meta = loaded
        for key, val in (("k", self.k), ("canonical", self.canonical),
                         ("chunk_size_reads", self.cfg.chunk_size_reads),
                         ("file_path", file_path)):
            if meta.get(key) != val:
                raise ValueError(
                    f"k-mer checkpoint {checkpoint_path} has {key}="
                    f"{meta.get(key)!r} but this run uses {key}={val!r}"
                )
        start_chunk = int(meta["chunks_done"])
        res.total_reads = int(meta["total_reads"])
        res.total_kmers = int(meta["total_kmers"])
        return base, start_chunk

    def _count_file_device(self, paths: list, res: KmerResult, progress,
                           start_chunk: int = 0, base: tuple = _EMPTY_ARRAYS,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 0,
                           result_mode: str = "full",
                           summary_top_n: int = 10) -> None:
        """Single-device path: the aggregate lives in HBM; per-batch D2H is
        one deferred scalar (the batch k-mer total).

        Checkpointing folds the accumulator into a host-side ``base`` triple
        every N chunks and restarts the accumulator; the final result is
        merge(base, final drain). Chunk contributions are independent, so
        skip+seed resume is exact."""
        import jax

        cap = self.device_capacity
        if cap is None:
            cap = capacity_for(_device_bytes_limit())
        lo_bits = 2 * (self.k // 2)  # pack_kmers' lo-word width
        acc = kmer.DeviceKmerAccumulator(capacity=cap, lo_bits=lo_bits)
        totals: list = []
        chunk_size = self.cfg.chunk_size_reads
        # flat (bytes, offsets) chunks with prefetch-threaded decode: no
        # per-read Python objects, gzip decode overlapped with pack/dispatch
        # (same discipline as the full-WGS loop, models/alignment.py)
        for idx, (flat, offs) in enumerate(fastq.prefetch(
            fastq.iter_flat_chunks_multi(paths, chunk_size, progress=progress)
        )):
            if idx < start_chunk:  # resume: counted in a prior run
                continue
            n_reads = len(offs) - 1
            res.total_reads += n_reads
            maxlen = int(np.diff(offs).max()) if n_reads else 1
            pad = max(self.cfg.read_pad, -(-(self.k + 7) // 8) * 8)
            while pad < maxlen:  # power-of-two growth: stable slab geometry
                pad *= 2
            arr, lens = encode.pad_batch_flat(
                flat, offs, pad_to=pad, pad_value=int(encode.PAD_A),
                rows_to=chunk_size,  # fixed slot count: no re-flush
            )
            pb = packedmod.pack_batch(arr, lens)
            hi, lo, ct, nu = kmer.unique_counts_packed(
                *packedmod.device_args(pb), k=self.k, canonical=self.canonical
            )
            acc.add(hi, lo, ct)
            totals.append(ct.sum())
            if (checkpoint_path and checkpoint_every
                    and (idx + 1) % checkpoint_every == 0):
                res.total_kmers += sum(int(t) for t in jax.device_get(totals))
                totals.clear()
                base = merge_sorted_arrays(base, acc.drain())
                acc = kmer.DeviceKmerAccumulator(  # fresh: drain() folded
                    capacity=cap, lo_bits=lo_bits,  # the old spill already
                )
                save_kmer_checkpoint(
                    checkpoint_path, base,
                    self._checkpoint_meta("|".join(paths), res, idx + 1),
                )
        res.total_kmers += sum(int(t) for t in jax.device_get(totals))
        if result_mode == "summary" and base[0].size == 0:
            s = acc.summary(top_n=summary_top_n)
            if s is not None:  # exact without the host spill store
                res.distinct_kmers = s["n_unique"]
                res.count_histogram = s["hist"]
                res.top_items = s["top"]
                return
            # spilled: exactness requires the host fold — full drain
        hi, lo, ct = merge_sorted_arrays(base, acc.drain())
        res.arrays = (hi, lo, ct)
        res.distinct_kmers = int(hi.size)

    def count_file(self, path, progress=None,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0,
                   result_mode: str = "full",
                   summary_top_n: int = 10) -> KmerResult:
        """Count one FASTQ lane — or a whole sample: ``path`` may be a LIST
        of lane files, streamed in order into one aggregate (chunk indices,
        and therefore checkpoint resume points, are global across the
        list). ``checkpoint_path`` + ``checkpoint_every`` enable
        crash-resumable counting (beyond the reference, which had no k-mer
        implementation at all): an .npz snapshot of the merged counts is
        written every N chunks, and a rerun resumes from it exactly.

        ``result_mode="summary"`` computes distinct count, multiplicity
        histogram, and top-N DEVICE-SIDE and never drains the count table
        (res.arrays stays empty) — the right call when the caller doesn't
        need the full dump (no --kmer-out): at 13M distinct keys the drain
        moves ~41.5 MB to the host.
        Falls back to the exact full drain whenever correctness requires
        host-side folding (spill overflow, resume base, mesh path)."""
        paths = fastq.as_paths(path)
        joined = "|".join(paths)
        res = KmerResult(file_path=joined, k=self.k, canonical=self.canonical)
        t0 = time.perf_counter()
        base, start_chunk = self._load_resume(checkpoint_path, res,
                                              file_path=joined)
        if self._use_device_acc():
            self._count_file_device(
                paths, res, progress, start_chunk=start_chunk, base=base,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, result_mode=result_mode,
                summary_top_n=summary_top_n,
            )
            res.seconds = time.perf_counter() - t0
            return res
        agg = self.make_store()
        for idx, (flat, offs) in enumerate(fastq.prefetch(
            fastq.iter_flat_chunks_multi(
                paths, self.cfg.chunk_size_reads, progress=progress)
        )):
            if idx < start_chunk:  # resume: counted in a prior run
                continue
            pad = self._pad_for(int(np.diff(offs).max()) if len(offs) > 1
                                else 1)
            arr, lens = encode.pad_batch_flat(
                flat, offs, pad_to=pad, pad_value=int(encode.PAD_A))
            n_kmers, n_reads = self._count_arr_batch(arr, lens, pad, agg)
            res.total_kmers += n_kmers
            res.total_reads += n_reads
            if (checkpoint_path and checkpoint_every
                    and (idx + 1) % checkpoint_every == 0):
                base = merge_sorted_arrays(base, self._agg_arrays(agg))
                agg = self.make_store()
                save_kmer_checkpoint(
                    checkpoint_path, base,
                    self._checkpoint_meta(joined, res, idx + 1),
                )
        hi, lo, ct = merge_sorted_arrays(base, self._agg_arrays(agg))
        res.arrays = (hi, lo, ct)
        res.distinct_kmers = int(hi.size)
        res.seconds = time.perf_counter() - t0
        return res
