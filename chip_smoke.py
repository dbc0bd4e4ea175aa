#!/usr/bin/env python3
"""Bring-up check on an NVIDIA GPU: every engine's main path, in one process.

    python chip_smoke.py               # one card: phases 0-3 below
    python chip_smoke.py --four-cards  # only the multi-card paths, 4 cards

Phase 0 refuses anything but a GPU and prints what the run stands on.
Phase 1 generates the data from fixed seeds: Illumina 2x150 bp, 2 lanes x
R1/R2 x 1,000,000 reads from a 32 Mbp genome; a 1 Mbp reference whose sample
carries planted SNPs and indels, with 200,000 reads; a 100 kb contig with
2,000 reads for the exhaustive rescue; a 200 kb identical pair.
Phase 2 drives every mode through the CLI entry point (``cli.main``) and
checks each answer against what the data was built to give.
Phase 3 runs the parity gate (tools/kernel_check.py): each device path at
real widths against its oracle, then the tests marked ``gpu``.

Everything runs in this one process (a JAX process reserves most of the
card); no phase's failure is caught. The last line of standard output is a
JSON object with the device JAX saw.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
READ_LEN = 150
LANE_READS = 1_000_000
CHUNK = 100_000
REF_LEN = 1_000_000
N_SNPS, N_INDELS = 1000, 100
VP_READS = 200_000
RESCUE_LEN, RESCUE_READS = 100_000, 2000
LONG_LEN = 200_000
KMER_SAMPLE_READS = 20_000  # --kmer-out writes one text line per k-mer


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 0

def phase0(need: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        sys.exit(1)
    if len(devs) < need:
        print(f"chip_smoke needs {need} GPUs; JAX found {len(devs)}",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from mini_parallel import device, native
    from mini_parallel.ops import sw_gpu

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    say(f"device: {devs[0].device_kind} x {len(devs)} "
        f"(platform {devs[0].platform})")
    for line in smi.stdout.strip().splitlines():
        say(f"nvidia-smi: {line}")
    say(f"jax {jax.__version__}")
    say(f"compile cache: {device.enable_compile_cache()}")
    say(f"native C++ data plane built: {native.available()}")
    t0 = time.perf_counter()
    say(f"CUDA SW kernel library: {sw_gpu.build()} "
        f"({time.perf_counter() - t0:.1f} s)")
    return devs


# ---------------------------------------------------------------- phase 1

def _write_fasta(path: str, name: str, seq: bytes) -> None:
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80].decode() + "\n")


def _write_reads(path: str, reads: np.ndarray) -> None:
    from mini_parallel.tools.make_scale_data import fastq_records

    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(fastq_records(reads, b"v", 0))


def _sample_reads(rng, genome: np.ndarray, n: int) -> np.ndarray:
    """n reads of READ_LEN from ``genome``, 0.5% substitutions, half of
    them reverse-complemented."""
    from mini_parallel.tools.make_scale_data import _BASES, revcomp

    s = rng.integers(0, genome.size - READ_LEN, size=n)
    reads = genome[s[:, None] + np.arange(READ_LEN)[None, :]]
    err = rng.random(reads.shape) < 0.005
    reads = np.where(err, _BASES[rng.integers(0, 4, reads.shape)], reads)
    flip = rng.random(n) < 0.5
    reads[flip] = revcomp(reads[flip])
    return reads


def phase1(tmp: str) -> dict:
    from mini_parallel.tools.make_scale_data import (_BASES, write_lane,
                                                         write_lanes)

    t0 = time.perf_counter()
    wgs = os.path.join(tmp, "wgs")
    lanes = write_lanes(wgs, 2, LANE_READS, READ_LEN, paired=True,
                        sample="SMK")
    rng = np.random.default_rng(20261016)
    ref = _BASES[rng.integers(0, 4, REF_LEN)]
    # planted variants, at least 300 bp apart so every read sees one event
    slots = rng.choice(np.arange(1000, REF_LEN - 1000, 300),
                       N_SNPS + N_INDELS, replace=False)
    snps = np.sort(slots[:N_SNPS])
    indels = np.sort(slots[N_SNPS:])
    sample = ref.copy()
    base_index = np.searchsorted(_BASES, ref[snps])  # ACGT is sorted
    sample[snps] = _BASES[(base_index + rng.integers(1, 4, N_SNPS)) % 4]
    pieces, last = [], 0
    for k, p in enumerate(indels):
        size = 1 + k % 5
        pieces.append(sample[last:p])
        if k % 2:  # insertion
            pieces.append(_BASES[rng.integers(0, 4, size)])
            last = p
        else:  # deletion
            last = p + size
    pieces.append(sample[last:])
    sample = np.concatenate(pieces)
    ref_fa = os.path.join(tmp, "ref.fa")
    _write_fasta(ref_fa, "chrS", ref.tobytes())
    vp_reads = os.path.join(tmp, "vp.fastq.gz")
    _write_reads(vp_reads, _sample_reads(rng, sample, VP_READS))
    contig_fa = os.path.join(tmp, "contig.fa")
    _write_fasta(contig_fa, "chrR", ref[:RESCUE_LEN].tobytes())
    rescue_reads = os.path.join(tmp, "rescue.fastq.gz")
    _write_reads(rescue_reads, _sample_reads(
        rng, sample[:RESCUE_LEN - 1000], RESCUE_READS))
    long_seq = _BASES[rng.integers(0, 4, LONG_LEN)].tobytes()
    long_a, long_b = (os.path.join(tmp, n) for n in ("la.fa", "lb.fa"))
    _write_fasta(long_a, "a", long_seq)
    _write_fasta(long_b, "b", long_seq)
    kmer_sample = os.path.join(tmp, "kmer_sample.fastq.gz")
    write_lane([kmer_sample], KMER_SAMPLE_READS, READ_LEN, seed=99)
    say(f"phase 1: data in {time.perf_counter() - t0:.1f} s "
        f"({4 * LANE_READS} lane reads, {VP_READS} variant-prep reads)")
    return dict(wgs=wgs, lanes=lanes, ref_fa=ref_fa, vp_reads=vp_reads,
                snps=snps, contig_fa=contig_fa, rescue_reads=rescue_reads,
                long_a=long_a, long_b=long_b, kmer_sample=kmer_sample)


# ---------------------------------------------------------------- phase 2

@contextlib.contextmanager
def _environ(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli(name: str, argv: list[str], workdir: str, env: dict | None = None
        ) -> list[str]:
    """One CLI run in its own working directory (checkpoints, logs and
    outputs land there); fails the phase unless it exits 0."""
    from mini_parallel.cli import main

    cwd = os.path.join(workdir, name)
    os.makedirs(cwd)
    lines: list[str] = []
    here = os.getcwd()
    t0 = time.perf_counter()
    os.chdir(cwd)
    try:
        with _environ({"GPU_CHUNK_SIZE_READS": str(CHUNK), **(env or {})}):
            rc = main(argv, echo=lambda m: lines.append(str(m)))
    finally:
        os.chdir(here)
    say(f"  {name}: rc={rc} in {time.perf_counter() - t0:.1f} s")
    check(rc == 0, f"{name} exited {rc}: {lines[-10:]}")
    return lines


def _grab(lines: list[str], pattern: str, cast=int):
    for line in lines:
        m = re.search(pattern, line)
        if m:
            return cast(m.group(1))
    raise AssertionError(f"no line matches {pattern!r}: {lines[-10:]}")


def _file_scores(lines: list[str]) -> list[tuple[int, int]]:
    return [(int(m.group(1)), int(m.group(2))) for m in
            (re.search(r"complete: Score=(\d+), Bases=(\d+)", x)
             for x in lines) if m]


def full_wgs(data: dict, work: str, mode: str, name: str,
             env: dict | None = None) -> list[tuple[int, int]]:
    wgs_env = {"WGS_DATA_DIR": data["wgs"], "WGS_SAMPLE_ID": "SMK",
               "WGS_LANES": "2", "WGS_READS_PER_LANE": "2", **(env or {})}
    scores = _file_scores(cli(name, ["--full-wgs", "--mode", mode], work,
                              wgs_env))
    check(len(scores) == 4, f"{name}: {len(scores)} files scored")
    return scores


def _snp_recall(vcf: str, snps: np.ndarray) -> tuple[float, dict]:
    called, gts = set(), {}
    with open(vcf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            pos = int(cols[1]) - 1
            called.add(pos)
            if len(cols) > 9:
                gts[pos] = cols[9].split(":")[0]
    hit = [int(p) in called for p in snps]
    return float(np.mean(hit)), gts


def _pair_sw_total(r1: str, r2: str) -> int:
    """Mate-pair SW total by the plain scan, chunk by chunk."""
    import jax.numpy as jnp

    from mini_parallel.io import fastq
    from mini_parallel.ops import encode, sw

    total = 0
    for (f1, o1), (f2, o2) in zip(fastq.iter_flat_chunks(r1, CHUNK),
                                  fastq.iter_flat_chunks(r2, CHUNK)):
        n = min(len(o1), len(o2)) - 1
        a, _ = encode.pad_batch_flat(f1, o1[:n + 1], pad_to=152,
                                     pad_value=int(encode.PAD_A))
        b, _ = encode.pad_batch_flat(f2, o2[:n + 1], pad_to=152,
                                     pad_value=int(encode.PAD_B))
        total += int(np.asarray(sw.sw_score_batch(jnp.asarray(a),
                                                  jnp.asarray(b))).sum())
    return total


def phase2(data: dict, work: str) -> None:
    r1, r2 = data["lanes"][0]
    chunks = -(-LANE_READS // CHUNK)

    scores = full_wgs(data, work, "kadane", "full-wgs-kadane")
    # reference parity: every >= 1000-base chunk of a self-alignment scores 2
    check(all(s == 2 * chunks for s, _ in scores), f"kadane {scores}")
    scores = full_wgs(data, work, "sw", "full-wgs-sw")
    # SW of an ACGT read against itself is 2 per base
    check(all(s == 2 * b for s, b in scores), f"sw {scores}")
    say(f"    full-wgs sw score total {sum(s for s, _ in scores)}")

    lines = cli("pair-files-sw", ["--files", "-1", r1, "-2", r2,
                                  "--mode", "sw"], work)
    got = _grab(lines, r"Alignment score: (\d+)")
    want = _pair_sw_total(r1, r2)
    check(got == want, f"pair-files sw {got} != scan {want}")

    lines = cli("complementarity", ["--complementarity", "-1", r1,
                                    "-2", r2], work)
    # the generator makes exactly 2% of mates reverse complements
    check(_grab(lines, r"Perfectly complementary: (\d+)")
          == LANE_READS // 50, "complementary pair count")

    lines = cli("kmer-summary", ["--kmer", r1, "-k", "21"], work)
    check(_grab(lines, r"Total 21-mers: (\d+)")
          == LANE_READS * (READ_LEN - 20), "k-mer total")
    check(_grab(lines, r"Distinct 21-mers: (\d+)") > 0, "k-mer distinct")
    lines = cli("kmer-out", ["--kmer", data["kmer_sample"], "-k", "21",
                             "--kmer-out", "k.tsv.gz"], work)
    distinct = _grab(lines, r"Distinct 21-mers: (\d+)")
    check(_grab(lines, r"Counts: (\d+) records") == distinct,
          "k-mer records written")

    vp = ["--variant-prep", data["vp_reads"], "--reference", data["ref_fa"],
          "--gapped"]
    for name, extra in (
            ("variant-gapped", ["--vcf-out", "v.vcf"]),
            ("variant-gapped-affine", ["--gap-model", "affine",
                                       "--vcf-out", "v.vcf",
                                       "--sam-out", "o.sam"]),
            ("variant-genotype", ["--genotype", "--vcf-out", "v.vcf"])):
        lines = cli(name, vp + extra, work)
        rate = _grab(lines, r"mapped: \d+ \(([\d.]+) %\)", float)
        recall, gts = _snp_recall(os.path.join(work, name, "v.vcf"),
                                  data["snps"])
        say(f"    {name}: mapped {rate} %, planted-SNP recall {recall:.4f}")
        check(rate >= 95.0, f"{name} mapping rate {rate}")
        check(recall >= 0.95, f"{name} SNP recall {recall}")
        if name == "variant-genotype":
            hom = np.mean([gts.get(int(p)) == "1/1" for p in data["snps"]])
            say(f"    genotype: planted SNPs called 1/1: {hom:.4f}")
            check(hom >= 0.9, f"hom-alt genotype share {hom}")

    lines = cli("variant-rescue", [
        "--variant-prep", data["rescue_reads"], "--reference",
        data["contig_fa"], "--rescue", "--chunk-size", "2048"], work)
    rate = _grab(lines, r"mapped: \d+ \(([\d.]+) %\)", float)
    check(rate >= 95.0, f"rescue mapping rate {rate}")

    for mode in ("sw", "sw-affine"):
        lines = cli(f"long-align-{mode}", [
            "--long-align", "-1", data["long_a"], "-2", data["long_b"],
            "--mode", mode], work)
        check(_grab(lines, r"Alignment score: (\d+)") == 2 * LONG_LEN,
              f"long-align {mode}")


# ---------------------------------------------------------------- phase 3

def phase3() -> None:
    import pytest

    from mini_parallel.tools import kernel_check

    failed = kernel_check.run(kernel_check.REAL)
    check(failed == 0, f"{failed} device paths differ from their oracles")
    # in this process JAX is already on the GPU, so tests/conftest.py
    # leaves the platform alone
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "-p", "no:xdist",
                      os.path.join(ROOT, "tests")])
    check(rc == 0, f"gpu-marked tests exited {rc}")


# ---------------------------------------------------------- four cards

def four_cards(work: str) -> None:
    """The multi-card paths only, each next to what it must equal."""
    import __graft_entry__
    from mini_parallel.tools.make_scale_data import write_lanes

    data = {"wgs": os.path.join(work, "wgs")}
    write_lanes(data["wgs"], 2, LANE_READS, READ_LEN, paired=True,
                sample="SMK")
    one = full_wgs(data, work, "sw", "full-wgs-sw-1card")
    four = full_wgs(data, work, "sw", "full-wgs-sw-mesh4",
                    env={"MPT_MESH_SHAPE": "4"})
    say(f"    score totals: one card {sum(s for s, _ in one)}, "
        f"4-card mesh {sum(s for s, _ in four)}")
    check(one == four, f"mesh scores {four} != one-card {one}")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    say(f"  dryrun_multichip(4): ok in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    args = ap.parse_args(argv)
    need = 4 if args.four_cards else 1
    devs = phase0(need)
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            four_cards(tmp)
        else:
            data = phase1(tmp)
            say("phase 2: every mode through the CLI")
            phase2(data, os.path.join(tmp, "runs"))
            say("phase 3: parity on the card")
            phase3()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
