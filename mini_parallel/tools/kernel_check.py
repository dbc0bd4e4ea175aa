"""Parity gate on the card: every device path vs its host oracle.

Each check runs the path a user reaches on the device, at the widths users
send (the 10k x 150 bp headline batch, 150 bp reads against 184 bp windows,
long pairs of 20 kb x 15 kb, ...), and compares a sample of its output with
the plain NumPy oracle. Integer paths must match exactly; the float32
Pair-HMM must stay within 2e-3 in log10 of the float64 oracle. One PASS/FAIL
row per path, GCUPS lines for information (not a benchmark record); exit 1
on any failure. ``chip_smoke.py`` runs it as its parity phase.

It refuses to run off the GPU unless ``--allow-cpu``, which also shrinks
every size so the tests can drive the same code on the CPU.

Usage: python -m mini_parallel.tools.kernel_check [--seed N] [--allow-cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Sizes:
    batch: int = 10_000        # headline pairs (and Pair-HMM pairs)
    read_len: int = 150
    sample: int = 256          # pairs checked against the quadratic oracle
    small_sample: int = 32     # for the slower Python oracles
    window: int = 184          # gapped variant-prep window
    tb_batch: int = 2048       # traceback chunk
    ref_len: int = 2000        # reads-vs-reference
    ref_reads: int = 2048
    ref_sample: int = 16
    long_a: int = 20_000
    long_b: int = 15_000
    hap_len: int = 300
    kmer_reads: int = 20_000


REAL = Sizes()
TINY = Sizes(batch=48, read_len=40, sample=8, small_sample=4, window=56,
             tb_batch=16, ref_len=300, ref_reads=16, ref_sample=4,
             long_a=900, long_b=700, hap_len=60, kmer_reads=64)

_BASES = np.frombuffer(b"ACGT", np.uint8)


def _rand(rng, n):
    return rng.choice(_BASES, n).tobytes()


def _mutate(rng, seq: bytes, rate: float = 0.03) -> bytes:
    arr = np.frombuffer(seq, np.uint8).copy()
    hit = rng.random(arr.size) < rate
    arr[hit] = rng.choice(_BASES, int(hit.sum()))
    return arr.tobytes()


def _pairs(rng, sz: Sizes):
    """Headline-shaped pairs: half related (mutated copies), half random."""
    a = [_rand(rng, sz.read_len) for _ in range(sz.batch)]
    b = [_mutate(rng, x) if i % 2 == 0 else _rand(rng, sz.read_len)
         for i, x in enumerate(a)]
    return a, b


def _padded(reads, width, pad):
    from mini_parallel.ops import encode

    arr, _ = encode.pad_batch(reads, pad_to=width, pad_value=int(pad))
    return arr


def _info(msg: str) -> None:
    """Rates are device numbers: print them only from a GPU run."""
    import jax

    if jax.default_backend() == "gpu":
        print(f"    info: {msg}")


def _gcups(fn, cells, *args) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return cells / float(np.median(times)) / 1e9


def check_sw(rng, sz: Sizes):
    """The headline batch through the engine's scorer and through the
    plain scan; both against the quadratic golden on a sample, and the two
    against each other on the whole batch."""
    import jax
    import jax.numpy as jnp

    from mini_parallel.ops import encode, sw
    from mini_parallel.ops.sw_gpu import route, sw_score_batch_best

    ra, rb = _pairs(rng, sz)
    width = -(-sz.read_len // 4) * 4
    a = jnp.asarray(_padded(ra, width, encode.PAD_A))
    b = jnp.asarray(_padded(rb, width, encode.PAD_B))
    best = np.asarray(sw_score_batch_best(a, b))
    scan = np.asarray(sw.sw_score_batch(a, b))
    want = [sw.sw_score_numpy(x, y) for x, y in
            zip(ra[: sz.sample], rb[: sz.sample])]
    ok = (np.array_equal(best, scan)
          and np.array_equal(best[: sz.sample], want))
    cells = sz.batch * sz.read_len * sz.read_len
    path = route(jax.default_backend(), width, width)
    if jax.default_backend() == "gpu":
        _info(f"{path} {_gcups(sw_score_batch_best, cells, a, b):.1f} "
              f"GCUPS, scan {_gcups(sw.sw_score_batch, cells, a, b):.1f} "
              f"GCUPS ({sz.batch} x {sz.read_len} bp)")
    return ok, f"{sz.batch} pairs, {path} == scan, {sz.sample} vs golden"


def check_sw_affine(rng, sz: Sizes):
    import jax
    import jax.numpy as jnp

    from mini_parallel.ops import encode, sw

    ra, rb = _pairs(rng, sz)
    a = jnp.asarray(_padded(ra, sz.read_len, encode.PAD_A))
    b = jnp.asarray(_padded(rb, sz.read_len, encode.PAD_B))
    got = np.asarray(sw.sw_affine_batch(a, b))
    n = sz.small_sample * 2
    want = [sw.sw_affine_numpy(x, y) for x, y in zip(ra[:n], rb[:n])]
    cells = sz.batch * sz.read_len * sz.read_len
    if jax.default_backend() == "gpu":
        _info(f"affine scan {_gcups(sw.sw_affine_batch, cells, a, b):.1f} "
              "GCUPS")
    return np.array_equal(got[:n], want), f"{sz.batch} pairs, {n} vs golden"


def check_kadane(rng, sz: Sizes):
    import jax.numpy as jnp

    from mini_parallel.ops import encode, kadane

    ra, rb = _pairs(rng, sz)
    a = _padded(ra, sz.read_len, encode.PAD_A)
    b = _padded(rb, sz.read_len, encode.PAD_B)
    lens = np.full(sz.batch, sz.read_len, np.int32)
    got = np.asarray(kadane.kadane_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(lens), jnp.asarray(lens)))
    want = [kadane.reference_align_score(x, y)
            for x, y in zip(ra[: sz.sample], rb[: sz.sample])]
    return (np.array_equal(got[: sz.sample], want),
            f"{sz.batch} pairs, {sz.sample} vs reference emulation")


def _window_pairs(rng, sz: Sizes, indel: int):
    """Reads cut from their windows with an indel every other read, like
    the gapped variant-prep chunks."""
    wins, reads = [], []
    for i in range(sz.tb_batch):
        w = _rand(rng, sz.window)
        s = int(rng.integers(0, sz.window - sz.read_len - indel))
        r = bytearray(_mutate(rng, w[s: s + sz.read_len + indel], 0.01))
        if i % 4 == 0:
            del r[sz.read_len // 3: sz.read_len // 3 + indel]
        elif i % 4 == 1:
            r[sz.read_len // 2: sz.read_len // 2] = b"G" * indel
        reads.append(bytes(r[: sz.read_len]))
        wins.append(w)
    return reads, wins


def _positions_want(aln, width):
    want = np.full(width, -1, np.int32)
    if aln.score > 0:
        qi, rj = aln.query_start, aln.ref_start
        for count, op in aln.cigar_ops():
            if op == "M":
                want[qi: qi + count] = np.arange(rj, rj + count)
                qi += count
                rj += count
            elif op == "I":
                qi += count
            else:
                rj += count
    return want


def _check_positions(rng, sz: Sizes, affine: bool):
    import jax.numpy as jnp

    from mini_parallel.ops import encode
    from mini_parallel.ops import sw_traceback as tb

    reads, wins = _window_pairs(rng, sz, indel=4 if affine else 3)
    width = -(-sz.read_len // 8) * 8
    a = jnp.asarray(_padded(reads, width, encode.PAD_A))
    b = jnp.asarray(_padded(wins, sz.window, encode.PAD_B))
    fn = tb.sw_affine_positions_batch if affine else tb.sw_positions_batch
    oracle = tb.sw_affine_align_numpy if affine else tb.sw_align_numpy
    score, pos = (np.asarray(x) for x in fn(a, b))
    for k in range(sz.small_sample):
        want = oracle(reads[k], wins[k])
        if score[k] != want.score or not np.array_equal(
                pos[k], _positions_want(want, width)):
            return False, f"pair {k}: device walk != golden walk"
    return True, (f"{sz.tb_batch} x {width} vs {sz.window}, "
                  f"{sz.small_sample} vs golden walk")


def check_positions(rng, sz: Sizes):
    return _check_positions(rng, sz, affine=False)


def check_positions_affine(rng, sz: Sizes):
    return _check_positions(rng, sz, affine=True)


def check_sw_vs_ref(rng, sz: Sizes):
    import jax.numpy as jnp

    from mini_parallel.ops import encode, sw

    ref = _rand(rng, sz.ref_len)
    reads = []
    for i in range(sz.ref_reads):
        s = int(rng.integers(0, sz.ref_len - sz.read_len))
        r = _mutate(rng, ref[s: s + sz.read_len], 0.02)
        reads.append(r if i % 5 else _rand(rng, sz.read_len))
    arr = _padded(reads, -(-sz.read_len // 8) * 8, encode.PAD_A)
    s, p = sw.sw_vs_ref_batch(jnp.asarray(arr),
                              jnp.asarray(np.frombuffer(ref, np.uint8)))
    s, p = np.asarray(s), np.asarray(p)
    for k in range(sz.ref_sample):
        gs, gp = sw.sw_vs_ref_numpy(reads[k], ref)
        if s[k] != gs or p[k] != gp:
            return False, f"read {k}: got ({s[k]},{p[k]}) want ({gs},{gp})"
    return True, (f"{sz.ref_reads} reads x {sz.ref_len} bp reference, "
                  f"{sz.ref_sample} vs golden (score + end)")


def _long_pair(rng, sz: Sizes, affine: bool):
    a = bytearray(_rand(rng, sz.long_a))
    b = bytearray(_rand(rng, sz.long_b))
    n = min(sz.long_a, sz.long_b) // 5
    seg = _rand(rng, n)
    a[n: 2 * n] = seg
    if affine:  # a gap inside the planted segment
        seg = seg[: n // 2] + _rand(rng, 30) + seg[n // 2:]
    b[n // 2: n // 2 + len(seg)] = seg
    return bytes(a), bytes(b[: sz.long_b])


def check_sw_long(rng, sz: Sizes):
    from mini_parallel.ops import sw_long

    a, b = _long_pair(rng, sz, affine=False)
    t0 = time.perf_counter()
    got = sw_long.sw_score_long(a, b)
    dt = time.perf_counter() - t0
    want = sw_long.sw_score_numpy_blocked(a, b)
    _info(f"strips {len(a) * len(b) / dt / 1e9:.2f} GCUPS (first call, "
          "compile included)")
    return got == want, f"{len(a)} x {len(b)}, score {got}"


def check_sw_affine_long(rng, sz: Sizes):
    from mini_parallel.ops import sw_long

    a, b = _long_pair(rng, sz, affine=True)
    got = sw_long.sw_affine_score_long(a, b)
    want = sw_long.sw_affine_numpy_blocked(a, b)
    return got == want, f"{len(a)} x {len(b)} affine, score {got}"


def check_pairhmm(rng, sz: Sizes):
    """The genotyper's batch call vs the float64 oracle on ``sz.sample``
    pairs: three in four are reads cut from their haplotype (the scaled
    float32 pass scores them), one in four random (they underflow float32
    and go through the float64 rescue)."""
    import jax.numpy as jnp

    from mini_parallel.ops import encode, pairhmm

    haps = [_rand(rng, sz.hap_len) for _ in range(sz.batch)]
    reads = []
    for i, h in enumerate(haps):
        s = int(rng.integers(0, sz.hap_len - sz.read_len))
        reads.append(_mutate(rng, h[s: s + sz.read_len], 0.01)
                     if i % 4 != 3 else _rand(rng, sz.read_len))
    quals = [rng.integers(10, 41, sz.read_len).astype(np.float64)
             for _ in reads]
    got = pairhmm.pairhmm_log10_batch(reads, quals, haps)
    n = sz.sample
    # the float32 pass alone on the compared pairs: its non-finite rows are
    # the ones pairhmm_log10_batch handed to the float64 rescue
    m = -(-sz.read_len // 8) * 8
    err = np.stack([10.0 ** (-q / 10.0) for q in quals[:n]])
    ll32 = np.asarray(pairhmm.pairhmm_batch(
        jnp.asarray(_padded(reads[:n], m, encode.PAD_A)),
        jnp.asarray(np.pad(err, ((0, 0), (0, m - sz.read_len)))
                    .astype(np.float32)),
        jnp.asarray(_padded(haps[:n], sz.hap_len, encode.PAD_B)),
        jnp.full((n,), sz.read_len, jnp.int32),
        jnp.full((n,), sz.hap_len, jnp.int32)))
    rescued = int((~np.isfinite(ll32)).sum())
    worst = 0.0
    for i in range(n):
        want = pairhmm.pairhmm_forward_numpy(reads[i], quals[i], haps[i])
        worst = max(worst, abs(float(got[i]) - want))
    return worst <= 2e-3, (
        f"{sz.batch} pairs {sz.read_len} vs {sz.hap_len}, {n} vs float64 "
        f"oracle ({n - rescued} float32, {rescued} float64 rescue), "
        f"max |dlog10| = {worst:.2e}")


def check_kmer(rng, sz: Sizes):
    """The k-mer engine's full path (file decode, device counting, drain)
    on one sample file vs the Python counter."""
    from mini_parallel.io import fastq
    from mini_parallel.models.kmer_model import KmerEngine
    from mini_parallel.ops import kmer
    from mini_parallel.utils.config import Config

    genome = _rand(rng, 200_000)
    reads = []
    for i in range(sz.kmer_reads):
        s = int(rng.integers(0, len(genome) - sz.read_len))
        reads.append(_mutate(rng, genome[s: s + sz.read_len], 0.005))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sample.fastq.gz")
        fastq.write_fastq(path, reads)
        res = KmerEngine(Config(chunk_size_reads=max(sz.kmer_reads // 4, 8)),
                         k=21).count_file(path)
    got = {kmer.key_to_string(h, lo, 21): c
           for (h, lo), c in res.counts.items()}
    want = kmer.count_kmers_python(reads, k=21)
    return got == want, f"{len(reads)} reads, {len(want)} distinct 21-mers"


CHECKS = [
    ("sw-headline", check_sw),
    ("sw-affine", check_sw_affine),
    ("kadane-parity", check_kadane),
    ("sw-positions", check_positions),
    ("sw-affine-positions", check_positions_affine),
    ("sw-vs-ref", check_sw_vs_ref),
    ("sw-long-strips", check_sw_long),
    ("sw-affine-long-strips", check_sw_affine_long),
    ("pairhmm-fwd", check_pairhmm),
    ("kmer-count", check_kmer),
]


def run(sizes: Sizes = REAL, seed: int = 0) -> int:
    """Run every check; returns the number that failed. A crash counts as
    a failure of that check, and the rest still run."""
    failures = 0
    for name, fn in CHECKS:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        try:
            ok, detail = fn(rng, sizes)
        except Exception as e:  # noqa: BLE001 — report, then go on
            ok, detail = False, f"EXCEPTION {type(e).__name__}: {e}"[:400]
        print(f"  {'PASS' if ok else 'FAIL'}  {name:22s} {detail} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        failures += 0 if ok else 1
    print(f"{len(CHECKS) - failures}/{len(CHECKS)} device paths match "
          f"their oracles")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allow-cpu", action="store_true",
                    help="run off the GPU at tiny sizes (tests only)")
    args = ap.parse_args(argv)

    import jax

    from mini_parallel import device

    device.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.allow_cpu:
        print(f"FAIL: kernel_check needs a GPU (platform={dev.platform}); "
              f"pass --allow-cpu to run the tiny CPU variant")
        return 1
    sizes = REAL if dev.platform == "gpu" else TINY
    print(f"parity gate on {dev.device_kind} (platform={dev.platform}, "
          f"seed={args.seed})")
    return 1 if run(sizes, args.seed) else 0


if __name__ == "__main__":
    sys.exit(main())
