"""CLI smoke matrix: every mode x key flag combination exits 0 and prints
its headline line. Guards the argument wiring (engines have their own
correctness tests); runs on the virtual CPU backend via --allow-cpu."""

from __future__ import annotations

import numpy as np
import pytest

from mini_parallel.cli import main
from mini_parallel.io import fasta, fastq
from tests.conftest import random_dna


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("climatrix")
    rng = np.random.default_rng(99)
    ref = random_dna(rng, 600)
    reads = []
    for _ in range(24):
        s = int(rng.integers(0, 500))
        reads.append(ref[s : s + 80])
    r1 = str(tmp / "r1.fastq.gz")
    r2 = str(tmp / "r2.fastq.gz")
    fastq.write_fastq(r1, reads)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    fastq.write_fastq(r2, [r.translate(rc)[::-1] for r in reads])
    fa = str(tmp / "ref.fa")
    fasta.write_fasta(fa, {"chrT": ref})
    return {"r1": r1, "r2": r2, "fa": fa, "tmp": tmp}


def _run(args, capsys, monkeypatch, fixtures, expect=None):
    monkeypatch.chdir(fixtures["tmp"])
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "10")
    rc = main(args + ["--allow-cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-800:]
    if expect:
        assert expect in out, out[-800:]
    return out


def test_direct_modes(capsys, monkeypatch, fixtures):
    for mode in ("kadane", "sw", "sw-affine", "contiguous"):
        _run(["-1", "ACGTACGT", "-2", "ACGAACGT", "--mode", mode],
             capsys, monkeypatch, fixtures, expect="Alignment score:")


def test_pair_files_modes(capsys, monkeypatch, fixtures):
    f = fixtures
    for mode in ("kadane", "sw"):
        _run(["--files", "-1", f["r1"], "-2", f["r2"], "--mode", mode],
             capsys, monkeypatch, fixtures, expect="Alignment score:")


def test_kmer_flags(capsys, monkeypatch, fixtures):
    f = fixtures
    _run(["--kmer", f["r1"], "-k", "15", "--canonical"],
         capsys, monkeypatch, fixtures, expect="Distinct 15-mers:")


def test_complementarity(capsys, monkeypatch, fixtures):
    f = fixtures
    out = _run(["--complementarity", "-1", f["r1"], "-2", f["r2"]],
               capsys, monkeypatch, fixtures, expect="Non-complementary:")
    assert "Non-complementary: 0.00 %" in out  # r2 is exact revcomp of r1


def test_variant_prep_flag_matrix(capsys, monkeypatch, fixtures):
    f = fixtures
    base = ["--variant-prep", f["r1"], "--reference", f["fa"]]
    for extra in ([], ["--gapped"], ["--gapped", "--gap-model", "affine"],
                  ["--rescue"], ["--min-base-quality", "5"]):
        _run(base + extra, capsys, monkeypatch, fixtures,
             expect="Candidate variant sites:")
    out = _run(base + ["--vcf-out", "m.vcf"], capsys, monkeypatch, fixtures)
    vcf = (fixtures["tmp"] / "m.vcf").read_text()
    assert "##contig=<ID=chrT,length=600>" in vcf


def test_kmer_checkpoint_flags(capsys, monkeypatch, fixtures):
    f = fixtures
    args = ["--kmer", f["r1"], "-k", "15",
            "--kmer-checkpoint", "kc.npz", "--kmer-checkpoint-every", "1"]
    _run(args, capsys, monkeypatch, fixtures, expect="Distinct 15-mers:")
    assert (fixtures["tmp"] / "kc.npz").exists()
    # second invocation resumes from the snapshot and still reports totals
    _run(args, capsys, monkeypatch, fixtures, expect="Distinct 15-mers:")


def test_variant_prep_checkpoint_flags(capsys, monkeypatch, fixtures):
    f = fixtures
    args = ["--variant-prep", f["r1"], "--reference", f["fa"],
            "--prep-checkpoint", "pc.npz", "--prep-checkpoint-every", "1"]
    _run(args, capsys, monkeypatch, fixtures, expect="Candidate variant sites:")
    assert (fixtures["tmp"] / "pc.npz").exists()
    _run(args, capsys, monkeypatch, fixtures, expect="Candidate variant sites:")


def test_variant_prep_genotype_flag(capsys, monkeypatch, fixtures):
    f = fixtures
    out = _run(["--variant-prep", f["r1"], "--reference", f["fa"],
                "--genotype", "--gt-window", "30", "--vcf-out", "g.vcf"],
               capsys, monkeypatch, fixtures,
               expect="Candidate variant sites:")
    assert "ERROR" not in out


def test_kmer_out_flag(capsys, monkeypatch, fixtures):
    f = fixtures
    out = _run(["--kmer", f["r1"], "-k", "15", "--kmer-out", "k.tsv"],
               capsys, monkeypatch, fixtures, expect="records -> k.tsv")
    assert (fixtures["tmp"] / "k.tsv").exists()


def test_long_align_modes(capsys, monkeypatch, fixtures, rng):
    from mini_parallel.ops.sw_long import (sw_affine_numpy_blocked,
                                               sw_score_numpy_blocked)

    tmp = fixtures["tmp"]
    a = random_dna(rng, 3000)
    b = random_dna(rng, 2500)
    fa = str(tmp / "la.fa")
    fb = str(tmp / "lb.fa")
    fasta.write_fasta(fa, {"a": a})
    fasta.write_fasta(fb, {"b": b})
    out = _run(["--long-align", "-1", fa, "-2", fb],
               capsys, monkeypatch, fixtures, expect="Alignment score:")
    assert f"Alignment score: {sw_score_numpy_blocked(a, b)}\n" in out
    out = _run(["--long-align", "-1", fa, "-2", fb, "--mode", "sw-affine"],
               capsys, monkeypatch, fixtures, expect="Alignment score:")
    assert f"Alignment score: {sw_affine_numpy_blocked(a, b)}\n" in out
    # unsupported mode errors cleanly
    monkeypatch.chdir(tmp)
    assert main(["--long-align", "-1", fa, "-2", fb, "--mode", "kadane",
                 "--allow-cpu"]) == 2
