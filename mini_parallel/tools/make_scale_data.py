"""Generate a WGS-scale synthetic lane set, seeded.

The reference is engineered around 51.8M reads per file
(smith_waterman/src/aligner.rs:214, ~415M reads total across the dataset,
main.rs:100-102). A multi-lane set of millions of reads exercises what small
test fixtures never touch: the k-mer accumulator's capacity and spill,
chunk-checkpoint cadence at real chunk counts, and steady-state (not
startup-dominated) throughput.

Reads are sampled from one synthetic genome (32 Mbp, seeded) so k-mer
content is repetitive (realistic for the merge path), with 0.5%
substitution errors, plus 2% pure-random reads to keep a distinct-key tail.
With ``--paired`` each lane gets R1 and R2 files: Illumina 2x150 bp mates
from the two ends of 300-500 bp fragments, R2 reverse-complemented.

Usage:
    python -m mini_parallel.tools.make_scale_data OUTDIR \
        [--lanes 8] [--reads-per-lane 1250000] [--read-len 150] [--paired]

Files are gzip FASTQ named {SAMPLE}_L00N_R{1,2}_001.fastq.gz (the
pipeline's lane glob; --sample sets the prefix, default SCALE).
"""
from __future__ import annotations

import argparse
import gzip
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = np.zeros(256, np.uint8)
_COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA",
                                                               np.uint8)
_GENOME_MB = 32  # 32 Mbp synthetic genome shared by all lanes (seeded)
_CHUNK = 50_000


def genome(seed: int = 1234, mbp: int = _GENOME_MB) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _BASES[rng.integers(0, 4, size=mbp * 1_000_000, dtype=np.int64)]


def revcomp(reads: np.ndarray) -> np.ndarray:
    """Reverse complement of ACGT uint8 rows."""
    return _COMPLEMENT[reads[..., ::-1]]


def fastq_records(reads: np.ndarray, tag: bytes, start: int) -> bytes:
    """FASTQ text for (n, L) uint8 reads named @{tag}{index:010d}, built
    with array operations (no per-read Python)."""
    n, L = reads.shape
    idx = np.arange(start, start + n, dtype=np.int64)
    digits = ((idx[:, None] // 10 ** np.arange(9, -1, -1)) % 10
              + ord("0")).astype(np.uint8)

    def const(b: bytes):
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

    rec = np.concatenate([
        const(b"@" + tag), digits, const(b"\n"), reads, const(b"\n+\n"),
        const(b"I" * L), const(b"\n"),
    ], axis=1)
    return rec.tobytes()


def _substitute(rng, reads: np.ndarray, rate: float) -> np.ndarray:
    err = rng.random(reads.shape) < rate
    return np.where(err, _BASES[rng.integers(0, 4, size=reads.shape)], reads)


def write_lane(paths: list[str], n_reads: int, read_len: int, seed: int,
               g: np.ndarray | None = None) -> None:
    """One lane: ``paths`` = [R1] for single-end or [R1, R2] for mates."""
    rng = np.random.default_rng(seed)
    g = genome() if g is None else g
    tag = b"r%d_" % seed
    handles = [gzip.open(p, "wb", compresslevel=1) for p in paths]
    try:
        for start in range(0, n_reads, _CHUNK):
            n = min(_CHUNK, n_reads - start)
            insert = rng.integers(300, 501, size=n)
            s = rng.integers(0, g.size - 500, size=n)
            r1 = g[s[:, None] + np.arange(read_len)[None, :]]
            r1 = _substitute(rng, r1, 0.005)
            n_rand = max(1, n // 50)  # the distinct-k-mer tail
            r1[:n_rand] = _BASES[rng.integers(0, 4, size=(n_rand, read_len))]
            mates = [r1]
            if len(paths) == 2:
                e = (s + insert)[:, None] - read_len + np.arange(read_len)
                r2 = _substitute(rng, revcomp(g[e]), 0.005)
                r2[:n_rand] = revcomp(r1[:n_rand])
                mates.append(r2)
            with ThreadPoolExecutor(len(mates)) as pool:
                list(pool.map(
                    lambda hr: hr[0].write(fastq_records(hr[1], tag, start)),
                    zip(handles, mates)))
    finally:
        for h in handles:
            h.close()


def lane_paths(outdir: str, sample: str, lane: int, paired: bool):
    return [os.path.join(outdir, f"{sample}_L{lane:03d}_R{r}_001.fastq.gz")
            for r in ((1, 2) if paired else (1,))]


def write_lanes(outdir: str, lanes: int, reads_per_lane: int,
                read_len: int = 150, paired: bool = False,
                sample: str = "SCALE") -> list[list[str]]:
    """Write every lane (lanes in parallel threads; gzip releases the
    GIL) and return their paths."""
    os.makedirs(outdir, exist_ok=True)
    g = genome()
    jobs = [lane_paths(outdir, sample, lane, paired)
            for lane in range(1, lanes + 1)]
    with ThreadPoolExecutor(min(lanes, os.cpu_count() or 4)) as pool:
        list(pool.map(
            lambda lp: write_lane(lp[1], reads_per_lane, read_len, lp[0], g),
            enumerate(jobs, start=1)))
    return jobs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--reads-per-lane", type=int, default=1_250_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--sample", default="SCALE")
    args = ap.parse_args()
    t0 = time.time()
    write_lanes(args.outdir, args.lanes, args.reads_per_lane, args.read_len,
                args.paired, args.sample)
    total = args.lanes * args.reads_per_lane
    print(f"wrote {args.lanes} lanes x {args.reads_per_lane} reads "
          f"({total} total, {args.read_len}bp"
          f"{', paired' if args.paired else ''}) in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
