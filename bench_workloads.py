"""Per-workload benchmark battery: one JSON line per engine.

Complements bench.py (the driver's single headline metric) with end-to-end
throughput for every workload on synthetic data, so cross-round perf
regressions are visible per subsystem. Writes nothing; prints JSON lines.

Usage: python bench_workloads.py [--reads 100000] [--ref 100000]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import tempfile
import time

import numpy as np


def _make_fixtures(tmp: str, n_reads: int, ref_len: int):
    rng = np.random.default_rng(0)
    alpha = np.array(list("ACGT"))
    ref = "".join(rng.choice(alpha, size=ref_len))
    lane = os.path.join(tmp, "lane.fastq.gz")
    with gzip.open(lane, "wt", compresslevel=1) as f:
        for i in range(n_reads):
            f.write(f"@r{i}\n{''.join(rng.choice(alpha, size=150))}\n+\nI\n")
    mapped = os.path.join(tmp, "mapped.fastq.gz")
    with gzip.open(mapped, "wt", compresslevel=1) as f:
        for i in range(n_reads):
            s = int(rng.integers(0, ref_len - 150))
            f.write(f"@m{i}\n{ref[s:s+150]}\n+\nI\n")
    return ref.encode(), lane, mapped


def _emit(name: str, unit_count: int, seconds: float, extra=None):
    print(json.dumps({
        "metric": name,
        "value": round(unit_count / seconds, 1),
        "unit": "reads_per_s",
        "seconds": round(seconds, 3),
        **({"extra": extra} if extra else {}),
    }))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--ref", type=int, default=100_000, dest="ref_len")
    args = ap.parse_args()

    from mini_parallel.device import enable_compile_cache

    enable_compile_cache()
    from mini_parallel.models.alignment import AlignmentEngine
    from mini_parallel.models.complementarity import ComplementarityEngine
    from mini_parallel.models.kmer_model import KmerEngine
    from mini_parallel.models.variant_prep import VariantPrepEngine
    from mini_parallel.utils.config import Config

    cfg = Config(chunk_size_reads=10_000)
    with tempfile.TemporaryDirectory() as tmp:
        ref, lane, mapped = _make_fixtures(tmp, args.reads, args.ref_len)

        def best(run, n=2):
            r = None
            for _ in range(n):
                r = run()
            return r

        for mode in ("kadane", "sw"):
            r = best(lambda m=mode: AlignmentEngine(cfg, mode=m)
                     .self_align_file(lane))
            _emit(f"self_align_{mode}", r.total_reads, r.seconds)
        r = best(lambda: ComplementarityEngine(cfg)
                 .analyze_lane_pair(lane, lane))
        _emit("complementarity_pairs", r.pairs, r.seconds)
        # summary mode = the default CLI path (no --kmer-out): distinct /
        # histogram / top-N computed device-side, count table never drained
        r = best(lambda: KmerEngine(cfg).count_file(
            lane, result_mode="summary"))
        _emit("kmer_k21_worst_case", r.total_reads, r.seconds,
              extra={"distinct": r.distinct_kmers,
                     # regime label: pre-r5 rows under this metric included
                     # the full table drain; r5+ measures the CLI-default
                     # summary path (device-side distinct/hist/top-N, no
                     # drain) — the drain regime now lives in
                     # kmer_k21_full_drain
                     "result_mode": "summary"})
        # full-drain variant (--kmer-out): ships the whole table
        r = best(lambda: KmerEngine(cfg).count_file(lane))
        _emit("kmer_k21_full_drain", r.total_reads, r.seconds,
              extra={"distinct": r.distinct_kmers, "result_mode": "full"})
        r = best(lambda: VariantPrepEngine(ref, cfg).process_file(mapped))
        _emit("variant_prep_ungapped", r.total_reads, r.seconds,
              extra={"mapping_rate": round(r.mapping_rate, 4)})
        gcfg = Config(chunk_size_reads=2_000)
        r = best(lambda: VariantPrepEngine(ref, gcfg, gapped=True)
                 .process_file(mapped))
        _emit("variant_prep_gapped", r.total_reads, r.seconds)
        r = best(lambda: VariantPrepEngine(ref, gcfg, gapped=True,
                                           gap_model="affine")
                 .process_file(mapped))
        _emit("variant_prep_gapped_affine", r.total_reads, r.seconds)

        # Pair-HMM forward: B read-vs-haplotype likelihoods per call
        import jax.numpy as jnp

        from mini_parallel.ops import encode
        from mini_parallel.ops.pairhmm import pairhmm_batch

        rng = np.random.default_rng(2)
        base = np.frombuffer(b"ACGT", np.uint8)
        B, M, N = 10_000, 150, 304
        arr_r, la = encode.pad_batch(
            [bytes(rng.choice(base, M)) for _ in range(B)],
            pad_to=152, pad_value=int(encode.PAD_A))
        arr_h, lb = encode.pad_batch(
            [bytes(rng.choice(base, 300)) for _ in range(B)],
            pad_to=N, pad_value=int(encode.PAD_B))
        pargs = (jnp.asarray(arr_r),
                 jnp.asarray(np.full((B, 152), 1e-3, np.float32)),
                 jnp.asarray(arr_h), jnp.asarray(la), jnp.asarray(lb))
        np.asarray(pairhmm_batch(*pargs))  # compile + drain

        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pairhmm_batch(*pargs).block_until_ready()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        _emit("pairhmm_forward_pairs", B, dt,
              extra={"gcups": round(B * M * 300 / dt / 1e9, 1)})

        # end-to-end genotyping: plant SNPs, map + pileup + Pair-HMM GT
        rng2 = np.random.default_rng(5)
        alpha2 = np.frombuffer(b"ACGT", np.uint8)
        gref = bytes(rng2.choice(alpha2, 20_000))
        n_sites = 40
        sites = sorted(rng2.choice(
            np.arange(200, 19_800, 120), n_sites, replace=False))
        hap = bytearray(gref)
        for s in sites:
            hap[s] = ord("ACGT"[(b"ACGT".index(gref[s:s+1]) + 1) % 4])
        hap = bytes(hap)
        greads = []
        for s in sites:
            for i in range(24):
                src = hap if i % 2 == 0 else gref  # het everywhere
                st = int(s) - 40 - (i % 12)
                greads.append(src[st:st + 100])
        gpath = os.path.join(tmp, "gt.fastq.gz")
        with gzip.open(gpath, "wt", compresslevel=1) as f:
            for i, r in enumerate(greads):
                f.write(f"@g{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
        import copy

        geng = VariantPrepEngine(gref, Config(chunk_size_reads=2_000),
                                 min_depth=3, alt_fraction=0.2)
        gres0 = geng.process_file(gpath)
        # warm once (remote compile of the map + Pair-HMM shapes), then time
        # the steady-state call — same warm-throughput convention as every
        # other row; outputs must be identical call to call
        gwarm = geng.genotype_candidates(gpath, copy.deepcopy(gres0))
        t0 = time.perf_counter()
        gres = geng.genotype_candidates(gpath, copy.deepcopy(gres0))
        gdt = time.perf_counter() - t0
        assert ([(c.pos, c.gt, c.gq, c.gl) for c in gres.candidates]
                == [(c.pos, c.gt, c.gq, c.gl) for c in gwarm.candidates])
        called = sum(1 for c in gres.candidates if c.gt is not None)
        _emit("genotype_sites", called, gdt,
              extra={"reads": len(greads), "sites": len(gres.candidates)})


if __name__ == "__main__":
    main()
