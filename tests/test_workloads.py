"""Complementarity + variant-prep workloads on synthetic data with known truth."""

import numpy as np
import pytest

from mini_parallel.io import fasta, fastq
from mini_parallel.models.complementarity import ComplementarityEngine
from mini_parallel.models.variant_prep import (
    SEED_K,
    VariantPrepEngine,
    write_candidates_vcf,
)
from mini_parallel.utils.config import Config
from tests.conftest import random_dna

RC = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(s: bytes) -> bytes:
    return s.translate(RC)[::-1]


@pytest.fixture
def cfg():
    return Config(chunk_size_reads=16, read_pad=64)


# ---------------------------------------------------------------- complement

def test_complementarity_known_fractions(tmp_path, rng, cfg):
    # 12 perfect mate pairs + 4 broken ones -> 25% non-complementary
    r1 = [random_dna(rng, 40) for _ in range(16)]
    r2 = [revcomp(r) for r in r1]
    for i in range(12, 16):  # corrupt r2 mates
        r2[i] = random_dna(rng, 40)
    f1, f2 = str(tmp_path / "R1.fastq.gz"), str(tmp_path / "R2.fastq.gz")
    fastq.write_fastq(f1, r1)
    fastq.write_fastq(f2, r2)
    eng = ComplementarityEngine(cfg, mode="sw")
    res = eng.analyze_lane_pair(f1, f2)
    assert res.pairs == 16
    assert res.perfect_pairs == 12
    assert res.pct_non_complementary == pytest.approx(25.0)
    # direct SW of r1 vs revcomp-mate == self alignment == 2*len for perfect
    assert res.comp_score_sum >= 12 * 80


def test_complementarity_kadane_mode(tmp_path, rng, cfg):
    r1 = [random_dna(rng, 30) for _ in range(8)]
    r2 = [revcomp(r) for r in r1]
    f1, f2 = str(tmp_path / "a.fastq.gz"), str(tmp_path / "b.fastq.gz")
    fastq.write_fastq(f1, r1)
    fastq.write_fastq(f2, r2)
    res = ComplementarityEngine(cfg, mode="kadane").analyze_lane_pair(f1, f2)
    assert res.pairs == 8 and res.perfect_pairs == 8
    assert res.pct_non_complementary == 0.0


# ---------------------------------------------------------------- fasta io

def test_fasta_roundtrip(tmp_path):
    recs = {"chr1": b"ACGT" * 50, "chr2": b"TTTTGGGG"}
    path = str(tmp_path / "ref.fasta.gz")
    fasta.write_fasta(path, recs)
    assert fasta.read_fasta(path) == recs
    assert fasta.read_first_sequence(path) == recs["chr1"]


# ------------------------------------------------------------- variant prep

@pytest.fixture
def ref_and_reads(rng):
    ref = random_dna(rng, 2000)
    reads = []
    # 30 clean reads tiled over the reference
    for i in range(30):
        start = int(rng.integers(0, 2000 - 100))
        reads.append((start, ref[start : start + 100]))
    return ref, reads


def test_variant_prep_clean_reads_no_candidates(tmp_path, rng, cfg, ref_and_reads):
    ref, reads = ref_and_reads
    path = str(tmp_path / "reads.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])
    eng = VariantPrepEngine(ref, cfg, min_depth=2, alt_fraction=0.2)
    res = eng.process_file(path)
    assert res.total_reads == 30
    assert res.mapping_rate == 1.0
    assert res.candidates == []
    # pileup counts exactly match read coverage
    cov = np.zeros(2000, int)
    for start, r in reads:
        cov[start : start + len(r)] += 1
    assert (res.pileup[:, :4].sum(axis=1) == cov).all()


def test_variant_prep_detects_snp(tmp_path, rng, cfg, ref_and_reads):
    ref, _ = ref_and_reads
    pos = 1000
    ref_base = ref[pos : pos + 1]
    alt = b"A" if ref_base != b"A" else b"C"
    reads = []
    for i in range(20):
        start = pos - 50 + (i % 7)  # overlap the SNP from several offsets
        r = bytearray(ref[start : start + 100])
        r[pos - start] = alt[0]
        reads.append(bytes(r))
    path = str(tmp_path / "snp.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(ref, cfg, min_depth=3, alt_fraction=0.5)
    res = eng.process_file(path)
    assert res.mapping_rate == 1.0
    hits = [c for c in res.candidates if c.pos == pos]
    assert len(hits) == 1
    c = hits[0]
    assert c.ref_base == ref_base.decode() and c.alt_base == alt.decode()
    assert c.depth == 20 and c.alt_count == 20

    vcf = str(tmp_path / "out.vcf")
    write_candidates_vcf(vcf, res)
    text = open(vcf).read()
    assert f"ref\t{pos+1}\t.\t{ref_base.decode()}\t{alt.decode()}" in text


def test_variant_prep_reverse_complement_reads(tmp_path, rng, cfg, ref_and_reads):
    ref, _ = ref_and_reads
    reads = [revcomp(ref[i * 60 : i * 60 + 100]) for i in range(10)]
    path = str(tmp_path / "rc.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(ref, cfg)
    res = eng.process_file(path)
    assert res.mapping_rate == 1.0
    assert res.candidates == []  # RC reads must not fake variants


def test_variant_prep_unmappable_reads(tmp_path, rng, cfg, ref_and_reads):
    ref, _ = ref_and_reads
    junk = [random_dna(rng, 80) for _ in range(5)]
    path = str(tmp_path / "junk.fastq.gz")
    fastq.write_fastq(path, junk)
    eng = VariantPrepEngine(ref, cfg)
    res = eng.process_file(path)
    # random 80-mers are overwhelmingly absent from a 2kb reference
    assert res.mapped_reads <= 1
    assert res.pileup[:, :4].sum() <= 100


def test_variant_prep_gapped_handles_indel_reads(tmp_path, cfg):
    # Reads carry a 2-base DELETION before a real SNP. Ungapped anchoring
    # shifts all post-indel bases, smearing the SNP; gapped (CIGAR) pileup
    # must still call it at the exact position. Local rng: the assertions
    # are sensitive to the exact alignment shape, so the data must not
    # depend on session-fixture draw order.
    rng = np.random.default_rng(2024)
    ref = random_dna(rng, 2000)
    snp_pos = 1200
    ref_base = ref[snp_pos : snp_pos + 1]
    alt = b"A" if ref_base != b"A" else b"C"
    reads = []
    for i in range(15):
        start = snp_pos - 60 + (i % 5)
        seg = bytearray(ref[start : start + 110])
        seg[snp_pos - start] = alt[0]
        del seg[30:32]  # 2-base deletion upstream of the SNP
        reads.append(bytes(seg))
    path = str(tmp_path / "indel.fastq.gz")
    fastq.write_fastq(path, reads)

    gapped = VariantPrepEngine(ref, cfg, min_depth=5, alt_fraction=0.6, gapped=True)
    res = gapped.process_file(path)
    assert res.mapping_rate == 1.0
    hits = [c for c in res.candidates if c.pos == snp_pos]
    assert len(hits) == 1
    assert hits[0].alt_base == alt.decode() and hits[0].depth == 15

    # the ungapped engine must NOT find it at the right position (the reads'
    # post-deletion bases land 2 positions off) — demonstrating why gapped
    # pileup exists
    ungapped = VariantPrepEngine(ref, cfg, min_depth=5, alt_fraction=0.6)
    res_u = ungapped.process_file(path)
    assert not any(c.pos == snp_pos and c.alt_base == alt.decode()
                   and c.depth >= 15 for c in res_u.candidates)


def test_variant_prep_gapped_clean_reads_identical_to_ungapped(
    tmp_path, rng, cfg, ref_and_reads
):
    ref, reads = ref_and_reads
    path = str(tmp_path / "clean2.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])
    a = VariantPrepEngine(ref, cfg, gapped=False).process_file(path)
    b = VariantPrepEngine(ref, cfg, gapped=True).process_file(path)
    assert (a.pileup == b.pileup).all()
    assert a.candidates == b.candidates == []


def test_variant_prep_packed_matches_unpacked(tmp_path, rng, ref_and_reads):
    """The fused packed ungapped step must reproduce the unpacked pileup."""
    ref, reads = ref_and_reads
    path = str(tmp_path / "vp.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])
    on = VariantPrepEngine(
        ref, Config(chunk_size_reads=16, read_pad=64, packed_transfer=True))
    off = VariantPrepEngine(
        ref, Config(chunk_size_reads=16, read_pad=64, packed_transfer=False))
    r_on, r_off = on.process_file(path), off.process_file(path)
    assert r_on.mapped_reads == r_off.mapped_reads
    np.testing.assert_array_equal(r_on.pileup, r_off.pileup)
    assert [(c.pos, c.alt_base) for c in r_on.candidates] == [
        (c.pos, c.alt_base) for c in r_off.candidates
    ]


def test_variant_prep_gapped_packed_matches_host(tmp_path, rng, ref_and_reads):
    """Fused on-device gapped pileup == host CIGAR-walk gapped pileup."""
    ref, reads = ref_and_reads
    gappy = []
    for i, (_start, r) in enumerate(reads):
        r = bytearray(r)
        if i % 3 == 0 and len(r) > 30:
            del r[15:17]  # 2bp deletion
        gappy.append(bytes(r))
    path = str(tmp_path / "gappy.fastq.gz")
    fastq.write_fastq(path, gappy)
    on = VariantPrepEngine(
        ref, Config(chunk_size_reads=16, read_pad=64, packed_transfer=True),
        gapped=True)
    off = VariantPrepEngine(
        ref, Config(chunk_size_reads=16, read_pad=64, packed_transfer=False),
        gapped=True)
    r_on, r_off = on.process_file(path), off.process_file(path)
    assert r_on.mapped_reads == r_off.mapped_reads
    np.testing.assert_array_equal(r_on.pileup, r_off.pileup)


def test_variant_prep_rescue_recovers_seed_misses(tmp_path, rng, ref_and_reads):
    """Reads with a SNP in their first seed window are unmapped by seeds but
    recovered by the exhaustive-SW rescue at the correct anchor."""
    ref, reads = ref_and_reads
    broken = []
    for start, r in reads:
        r = bytearray(r)
        for pos in (4, 21, 38, 55):  # one SNP inside each tried seed window
            r[pos] = ord("A") if r[pos] != ord("A") else ord("C")
        broken.append((start, bytes(r)))
    path = str(tmp_path / "broken.fastq.gz")
    fastq.write_fastq(path, [r for _, r in broken])
    cov = np.zeros(len(ref), int)
    for start, r in broken:
        cov[start : start + len(r)] += 1
    for packed in (True, False):  # rescue must work on BOTH transfer paths
        cfg = Config(chunk_size_reads=16, read_pad=112, packed_transfer=packed)
        base = VariantPrepEngine(ref, cfg)
        resc = VariantPrepEngine(ref, cfg, rescue=True)
        r_base = base.process_file(path)
        r_resc = resc.process_file(path)
        assert r_base.mapping_rate < 1.0  # seeds alone miss some
        assert r_resc.mapping_rate == 1.0  # rescue recovers every read
        # rescued reads pile up at their true positions
        depth = r_resc.pileup[:, :5].sum(axis=1)
        np.testing.assert_array_equal(depth, cov)


def test_variant_prep_multi_contig(tmp_path, rng):
    """Two contigs: reads map per contig, a SNP reports contig-local
    coordinates, spacers never become candidate sites."""
    from mini_parallel.models.variant_prep import write_candidates_vcf

    c1 = random_dna(rng, 800)
    c2 = random_dna(rng, 600)
    reads = []
    for _ in range(40):
        s1 = int(rng.integers(0, 700))
        reads.append(c1[s1 : s1 + 100])
    snp_pos = 300  # plant a SNP in contig2 at local position 300
    alt = b"A" if c2[snp_pos : snp_pos + 1] != b"A" else b"C"
    for _ in range(40):
        s2 = int(rng.integers(200, 350))
        r = bytearray(c2[s2 : s2 + 100])
        if s2 <= snp_pos < s2 + 100:
            r[snp_pos - s2] = alt[0]
        reads.append(bytes(r))
    path = str(tmp_path / "mc.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(
        {"chr1": c1, "chr2": c2},
        Config(chunk_size_reads=16, read_pad=112),
        min_depth=3, alt_fraction=0.5,
    )
    res = eng.process_file(path)
    assert res.mapping_rate == 1.0
    assert [(c.contig, c.pos, c.alt_base) for c in res.candidates] == [
        ("chr2", snp_pos, alt.decode())
    ]
    vcf = tmp_path / "out.vcf"
    write_candidates_vcf(str(vcf), res, contigs=eng.contig_table())
    text = vcf.read_text()
    assert "##contig=<ID=chr1,length=800>" in text
    assert "##contig=<ID=chr2,length=600>" in text
    assert f"chr2\t{snp_pos+1}\t" in text


def test_variant_prep_gapped_indel_candidates(tmp_path):
    """A shared deletion / insertion in the reads surfaces as a <DEL>/<INS>
    candidate at the right site in gapped mode."""
    rng = np.random.default_rng(123)  # local: alignment-shape assertions
    ref = random_dna(rng, 1200)
    del_at, ins_at = 400, 800
    reads = []
    for _ in range(25):
        s = int(rng.integers(340, 380))  # read spans the deletion site
        r = bytearray(ref[s : s + 100])
        d = del_at - s
        del r[d : d + 3]  # 3bp deletion relative to the reference
        reads.append(bytes(r))
    for _ in range(25):
        s = int(rng.integers(740, 780))  # read spans the insertion site
        r = bytearray(ref[s : s + 100])
        i = ins_at - s
        r[i:i] = b"GGG"  # 3bp insertion
        reads.append(bytes(r))
    path = str(tmp_path / "indel.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(
        ref, Config(chunk_size_reads=16, read_pad=112),
        min_depth=5, alt_fraction=0.5, gapped=True,
    )
    res = eng.process_file(path)
    assert res.mapping_rate == 1.0
    dels = [c for c in res.candidates if c.alt_base == "<DEL>"]
    inss = [c for c in res.candidates if c.alt_base == "<INS>"]
    # gap placement can shift by a base or two when the gap edge repeats
    assert len(dels) == 1 and abs(dels[0].pos - del_at) <= 2
    assert len(inss) == 1 and abs(inss[0].pos - ins_at) <= 3
    assert dels[0].alt_count >= 20 and inss[0].alt_count >= 20
    # no spurious SNP candidates from the indel smear (gapped realignment)
    snps = [c for c in res.candidates if len(c.alt_base) == 1]
    assert snps == []


def test_variant_prep_min_base_quality(tmp_path):
    """A fake SNP carried only by low-quality bases disappears when
    min_base_quality filters it — including on reverse-complement-mapped
    reads (the mask must flip with the read)."""
    import gzip

    rng = np.random.default_rng(77)
    ref = random_dna(rng, 1000)
    site = 500
    alt = b"A" if ref[site : site + 1] != b"A" else b"C"
    rc_tab = bytes.maketrans(b"ACGT", b"TGCA")
    recs = []
    for i in range(30):
        s = int(rng.integers(440, 480))
        r = bytearray(ref[s : s + 100])
        off = site - s
        r[off] = alt[0]
        qual = bytearray(b"I" * 100)
        qual[off] = ord("#")  # Phred 2: below any sane threshold
        if i % 2:  # half the reads on the reverse strand
            r = bytes(r).translate(rc_tab)[::-1]
            qual = qual[::-1]
        recs.append(f"@r{i}\n{bytes(r).decode()}\n+\n{bytes(qual).decode()}\n")
    path = tmp_path / "lowq.fastq.gz"
    path.write_bytes(gzip.compress("".join(recs).encode()))

    for packed in (True, False):
        cfg = Config(chunk_size_reads=16, read_pad=112, packed_transfer=packed)
        loose = VariantPrepEngine(ref, cfg, min_depth=3, alt_fraction=0.5)
        strict = VariantPrepEngine(ref, cfg, min_depth=3, alt_fraction=0.5,
                                   min_base_quality=10)
        r_loose = loose.process_file(str(path))
        r_strict = strict.process_file(str(path))
        assert r_loose.mapping_rate == 1.0 and r_strict.mapping_rate == 1.0
        assert [(c.pos, c.alt_base) for c in r_loose.candidates] == [
            (site, alt.decode())
        ]
        assert r_strict.candidates == []
        # only the filtered base disappears from the pileup
        assert r_strict.pileup[site, :4].sum() == 0
        assert r_strict.pileup[site - 1, :4].sum() == 30


def test_variant_prep_gapped_affine_matches_linear_on_clean_indels(tmp_path):
    """Affine and linear gapped pileups agree on clean single-indel reads,
    and affine packed == affine raw."""
    rng = np.random.default_rng(321)
    ref = random_dna(rng, 900)
    del_at = 430  # one shared absolute deletion site
    reads = []
    for _ in range(20):
        s = int(rng.integers(350, 390))
        r = bytearray(ref[s : s + 100])
        d = del_at - s
        del r[d : d + 3]
        reads.append(bytes(r))
    path = str(tmp_path / "aff.fastq.gz")
    fastq.write_fastq(path, reads)
    results = {}
    for gm in ("linear", "affine"):
        for packed in (True, False):
            eng = VariantPrepEngine(
                ref,
                Config(chunk_size_reads=16, read_pad=112,
                       packed_transfer=packed),
                min_depth=5, alt_fraction=0.5, gapped=True, gap_model=gm,
            )
            results[(gm, packed)] = eng.process_file(path)
    for gm in ("linear", "affine"):
        np.testing.assert_array_equal(
            results[(gm, True)].pileup, results[(gm, False)].pileup,
            err_msg=f"packed/raw mismatch ({gm})")
        dels = [c for c in results[(gm, True)].candidates
                if c.alt_base == "<DEL>"]
        assert len(dels) == 1 and dels[0].alt_count == 20, gm
    np.testing.assert_array_equal(
        results[("affine", True)].pileup, results[("linear", True)].pileup)


def test_complementarity_sharded_matches_local(tmp_path, rng, mesh8):
    from mini_parallel.models.complementarity import ComplementarityEngine

    r1 = [random_dna(rng, 40) for _ in range(19)]
    rc_tab = bytes.maketrans(b"ACGT", b"TGCA")
    # half the mates perfectly complementary, half random
    r2 = [r.translate(rc_tab)[::-1] if i % 2 else random_dna(rng, 40)
          for i, r in enumerate(r1)]
    f1, f2 = str(tmp_path / "s1.fastq.gz"), str(tmp_path / "s2.fastq.gz")
    fastq.write_fastq(f1, r1)
    fastq.write_fastq(f2, r2)
    cfg = Config(chunk_size_reads=7, read_pad=48)
    local = ComplementarityEngine(cfg).analyze_lane_pair(f1, f2)
    shard = ComplementarityEngine(cfg, mesh=mesh8).analyze_lane_pair(f1, f2)
    assert (shard.pairs, shard.direct_score_sum, shard.comp_score_sum,
            shard.perfect_pairs) == (
        local.pairs, local.direct_score_sum, local.comp_score_sum,
        local.perfect_pairs)
    assert shard.perfect_pairs == 9


def test_positions_to_cigar_shapes():
    from mini_parallel.models.variant_prep import positions_to_cigar

    # clean full-length match
    assert positions_to_cigar(np.arange(10, 20, dtype=np.int32), 10) == ("10M", 10)
    # 2bp deletion between query bases 4 and 5
    pos = np.array([5, 6, 7, 8, 9, 12, 13, 14], np.int32)
    assert positions_to_cigar(pos, 8) == ("5M2D3M", 5)
    # 2bp insertion (unaligned query bases mid-read)
    pos = np.array([5, 6, 7, -1, -1, 8, 9, 10], np.int32)
    assert positions_to_cigar(pos, 8) == ("3M2I3M", 5)
    # soft clips on both ends
    pos = np.array([-1, -1, 30, 31, 32, -1], np.int32)
    assert positions_to_cigar(pos, 6) == ("2S3M1S", 30)
    # unmapped
    assert positions_to_cigar(np.full(5, -1, np.int32), 5) == ("", -1)


def test_write_sam_end_to_end(tmp_path):
    from mini_parallel.models.variant_prep import write_sam

    rng = np.random.default_rng(42)
    ref = random_dna(rng, 900)
    rc_tab = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    truths = []
    for i in range(12):
        s = int(rng.integers(0, 780))
        r = bytearray(ref[s : s + 90])
        has_del = i % 4 == 1
        if has_del:
            del r[40:43]
        strand = 16 if i % 2 else 0
        out = bytes(r)
        if strand:
            out = out.translate(rc_tab)[::-1]
        reads.append(out)
        truths.append((s + 1, has_del, strand))
    reads.append(random_dna(rng, 50))  # unmapped
    truths.append((0, False, 4))
    path = str(tmp_path / "m.fastq.gz")
    fastq.write_fastq(path, reads)
    # affine gaps: one 3D run is strictly cheaper than split gaps, so the
    # expected CIGAR is unambiguous (linear costs tie and may split)
    eng = VariantPrepEngine(
        {"chrS": ref}, Config(chunk_size_reads=8, read_pad=96), gapped=True,
        gap_model="affine",
    )
    sam = str(tmp_path / "out.sam")
    st = write_sam(sam, eng, path)
    assert st == {"records": 13, "mapped": 12}
    lines = [l for l in open(sam) if not l.startswith("@")]
    assert len(lines) == 13
    header = open(sam).readline()
    assert header.startswith("@HD")
    assert "@SQ\tSN:chrS\tLN:900" in open(sam).read()
    import re

    for line, (pos1, has_del, flag) in zip(lines, truths):
        cols = line.rstrip("\n").split("\t")
        assert int(cols[1]) == flag, line
        if flag == 4:
            assert cols[5] == "*"
            continue
        assert cols[2] == "chrS"
        # gap runs can slide a base along repeats at equal affine score
        assert abs(int(cols[3]) - pos1) <= 1, (line, pos1)
        if has_del:
            m = re.fullmatch(r"(\d+)M3D(\d+)M", cols[5])
            assert m, (line, "expected one 3D run")
            assert int(m.group(1)) + int(m.group(2)) == 87
        else:
            assert cols[5] == "90M", line
        assert len(cols[9]) == (87 if has_del else 90)


# ----------------------------------------------------- prep checkpoint/resume

@pytest.mark.parametrize("gapped", [False, True])
def test_variant_prep_checkpoint_resume_exact(tmp_path, rng, cfg,
                                              ref_and_reads, gapped):
    ref, reads = ref_and_reads
    path = str(tmp_path / "reads.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])  # 30 reads / chunk 16
    ckpt = str(tmp_path / "prep.npz")

    clean = VariantPrepEngine(ref, cfg, gapped=gapped).process_file(path)

    # first run dies after chunk 1's snapshot (patched at the flat-chunk
    # layer the no-quals pipeline reads)
    real_flat = fastq.iter_flat_chunks

    def dying_flat(p, n, **kw):
        for i, c in enumerate(real_flat(p, n, **kw)):
            if i == 1:
                raise RuntimeError("injected crash")
            yield c

    fastq.iter_flat_chunks = dying_flat
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            VariantPrepEngine(ref, cfg, gapped=gapped).process_file(
                path, checkpoint_path=ckpt, checkpoint_every=1)
    finally:
        fastq.iter_flat_chunks = real_flat

    import json

    with np.load(ckpt) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["chunks_done"] == 1 and meta["total_reads"] == 16

    res = VariantPrepEngine(ref, cfg, gapped=gapped).process_file(
        path, checkpoint_path=ckpt, checkpoint_every=1)
    assert res.total_reads == clean.total_reads == 30
    assert res.mapped_reads == clean.mapped_reads
    assert (res.pileup == clean.pileup).all()
    assert [
        (c.contig, c.pos, c.ref_base, c.alt_base) for c in res.candidates
    ] == [(c.contig, c.pos, c.ref_base, c.alt_base) for c in clean.candidates]


def test_variant_prep_checkpoint_mismatch_refuses(tmp_path, rng, cfg,
                                                  ref_and_reads):
    ref, reads = ref_and_reads
    path = str(tmp_path / "reads.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])
    ckpt = str(tmp_path / "prep.npz")
    VariantPrepEngine(ref, cfg).process_file(path, checkpoint_path=ckpt,
                                             checkpoint_every=1)
    with pytest.raises(ValueError, match="gapped"):
        VariantPrepEngine(ref, cfg, gapped=True).process_file(
            path, checkpoint_path=ckpt, checkpoint_every=1)
    with pytest.raises(ValueError, match="reference_length"):
        VariantPrepEngine(ref + b"ACGT" * 10, cfg).process_file(
            path, checkpoint_path=ckpt, checkpoint_every=1)


def test_variant_prep_checkpoint_with_sam_out_refused(tmp_path, cfg,
                                                      ref_and_reads):
    ref, reads = ref_and_reads
    path = str(tmp_path / "reads.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])
    with pytest.raises(ValueError, match="checkpointing with sam_out"):
        VariantPrepEngine(ref, cfg, gapped=True).process_file(
            path, sam_out=str(tmp_path / "o.sam"),
            checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=1)


# ------------------------------------------------------------- genotyping

def _mutate(ref: bytes, pos: int, alt: bytes) -> bytes:
    return ref[:pos] + alt + ref[pos + 1:]


def test_genotype_candidates_het_and_hom(tmp_path, rng, cfg):
    ref = random_dna(rng, 2000)
    het_pos, hom_pos = 600, 1400
    het_alt = b"A" if ref[het_pos : het_pos + 1] != b"A" else b"C"
    hom_alt = b"G" if ref[hom_pos : hom_pos + 1] != b"G" else b"T"
    hap_het = _mutate(ref, het_pos, het_alt)
    hap_hom = _mutate(ref, hom_pos, hom_alt)
    reads = []
    for i in range(40):  # 20 reads per site, het: half carry the alt
        src = hap_het if (i % 2 == 0) else ref
        s = het_pos - 20 - (i % 10)
        reads.append(src[s : s + 60])
    for i in range(20):  # hom: every read carries the alt
        s = hom_pos - 20 - (i % 10)
        reads.append(hap_hom[s : s + 60])
    path = str(tmp_path / "gt.fastq.gz")
    fastq.write_fastq(path, reads)

    eng = VariantPrepEngine(ref, cfg, min_depth=3, alt_fraction=0.2)
    res = eng.process_file(path)
    res = eng.genotype_candidates(path, res)
    by_pos = {c.pos: c for c in res.candidates}
    assert het_pos in by_pos and hom_pos in by_pos
    het, hom = by_pos[het_pos], by_pos[hom_pos]
    assert het.gt == "0/1" and hom.gt == "1/1"
    assert het.gq > 0 and hom.gq > 0
    # GL ordering matches the genotypes
    assert het.gl[1] > het.gl[0] and het.gl[1] > het.gl[2]
    assert hom.gl[2] > hom.gl[1] > hom.gl[0]

    # VCF carries GT:GQ:PL with PL=0 for the called genotype
    vcf_path = str(tmp_path / "gt.vcf")
    write_candidates_vcf(vcf_path, res)
    vcf = open(vcf_path).read()
    assert "##FORMAT=<ID=PL" in vcf and "\tFORMAT\tSAMPLE" in vcf
    for line in vcf.splitlines():
        if line.startswith("#"):
            continue
        fields = line.split("\t")
        assert fields[8] == "GT:GQ:PL"
        gt, gq, pl = fields[9].split(":")
        if gt != "./.":
            pls = [int(x) for x in pl.split(",")]
            assert min(pls) == 0
            assert pls[("0/0", "0/1", "1/1").index(gt)] == 0
            # QUAL == the 0/0 PL (Phred confidence a variant exists)
            assert int(fields[5]) == min(pls[0], 9999)


def test_genotype_rc_reads_and_no_coverage(tmp_path, rng, cfg):
    ref = random_dna(rng, 1200)
    pos = 500
    alt = b"T" if ref[pos : pos + 1] != b"T" else b"A"
    hap = _mutate(ref, pos, alt)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(20):  # hom-alt site covered ONLY by rc-strand reads
        s = pos - 25 - (i % 8)
        reads.append(hap[s : s + 60].translate(rc)[::-1])
    path = str(tmp_path / "rc.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(ref, cfg, min_depth=3, alt_fraction=0.2)
    res = eng.process_file(path)
    res = eng.genotype_candidates(path, res)
    by_pos = {c.pos: c for c in res.candidates}
    assert by_pos[pos].gt == "1/1"  # rc orientation + qual reversal correct


def test_genotype_single_base_deletion(tmp_path, rng, cfg):
    ref = random_dna(rng, 1500)
    dpos = 700
    hap = ref[:dpos] + ref[dpos + 1:]  # homozygous 1bp deletion
    reads = []
    for i in range(24):
        s = dpos - 30 - (i % 10)
        reads.append(hap[s : s + 60])
    path = str(tmp_path / "del.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(ref, cfg, gapped=True, min_depth=3,
                            alt_fraction=0.2)
    res = eng.process_file(path)
    res = eng.genotype_candidates(path, res)
    dels = [c for c in res.candidates if c.alt_base == "<DEL>"]
    assert dels, "gapped pileup should flag the deletion site"
    called = [c for c in dels if c.gt is not None]
    assert called and all(c.gt == "1/1" for c in called)
    assert all(c.gl[2] > c.gl[0] for c in called)


# ------------------------------------------------------------- mesh sharding

@pytest.mark.parametrize("gapped,minq", [(False, 0), (True, 0), (False, 10)])
def test_variant_prep_sharded_matches_local(tmp_path, rng, cfg, ref_and_reads,
                                            mesh8, gapped, minq):
    ref, reads = ref_and_reads
    path = str(tmp_path / "reads.fastq.gz")
    fastq.write_fastq(path, [r for _, r in reads])
    kw = dict(gapped=gapped, min_base_quality=minq)
    local = VariantPrepEngine(ref, cfg, **kw).process_file(path)
    shard = VariantPrepEngine(ref, cfg, mesh=mesh8, **kw).process_file(path)
    assert shard.total_reads == local.total_reads
    assert shard.mapped_reads == local.mapped_reads
    assert (shard.pileup == local.pileup).all()
    assert [(c.contig, c.pos, c.alt_base) for c in shard.candidates] == \
           [(c.contig, c.pos, c.alt_base) for c in local.candidates]


def test_genotype_candidates_sharded_matches_local(tmp_path, rng, cfg, mesh8):
    ref = random_dna(rng, 1200)
    pos = 500
    alt = b"T" if ref[pos : pos + 1] != b"T" else b"A"
    hap = ref[:pos] + alt + ref[pos + 1:]
    reads = [hap[pos - 25 - (i % 8) : pos + 35 - (i % 8)] for i in range(16)]
    path = str(tmp_path / "gts.fastq.gz")
    fastq.write_fastq(path, reads)
    kw = dict(min_depth=3, alt_fraction=0.2)
    local = VariantPrepEngine(ref, cfg, **kw)
    lres = local.genotype_candidates(path, local.process_file(path))
    shard = VariantPrepEngine(ref, cfg, mesh=mesh8, **kw)
    sres = shard.genotype_candidates(path, shard.process_file(path))
    lc = {c.pos: c for c in lres.candidates}
    sc = {c.pos: c for c in sres.candidates}
    assert sc.keys() == lc.keys()
    for p in lc:
        assert sc[p].gt == lc[p].gt
        if lc[p].gl is not None:
            np.testing.assert_allclose(sc[p].gl, lc[p].gl, atol=1e-6)


def test_genotype_multi_contig_and_edge_window(tmp_path, rng):
    """Genotyping with two contigs: haplotype windows use contig-local
    bounds (never crossing the N spacer), including a SNP 5bp from a
    contig's start where the window clips."""
    c1 = random_dna(rng, 700)
    c2 = random_dna(rng, 500)
    edge_pos = 5  # near the start of contig2: window must clip at 0
    alt = b"G" if c2[edge_pos : edge_pos + 1] != b"G" else b"T"
    hap2 = c2[:edge_pos] + alt + c2[edge_pos + 1:]
    reads = []
    for i in range(30):  # background on contig1
        s = int(rng.integers(0, 600))
        reads.append(c1[s : s + 100])
    for i in range(20):  # hom-alt coverage of the edge SNP
        reads.append(hap2[0 : 60 + (i % 7)])
    path = str(tmp_path / "mcgt.fastq.gz")
    fastq.write_fastq(path, reads)
    eng = VariantPrepEngine(
        {"chr1": c1, "chr2": c2},
        Config(chunk_size_reads=16, read_pad=112),
        min_depth=3, alt_fraction=0.5,
    )
    res = eng.process_file(path)
    res = eng.genotype_candidates(path, res, window=50)
    hits = [(c.contig, c.pos) for c in res.candidates]
    assert ("chr2", edge_pos) in hits
    c = next(c for c in res.candidates
             if c.contig == "chr2" and c.pos == edge_pos)
    assert c.gt == "1/1" and c.gl[2] > c.gl[0]


def test_genotype_insertion_inference(tmp_path, rng, cfg):
    ref = random_dna(rng, 1500)
    anchor = 700  # homozygous 3bp insertion between ref[700] and ref[701]
    ins = b"TGA"
    hap = ref[: anchor + 1] + ins + ref[anchor + 1:]
    reads = []
    for i in range(24):
        s = anchor - 30 - (i % 10)
        reads.append(hap[s : s + 64])
    path = str(tmp_path / "ins.fastq.gz")
    fastq.write_fastq(path, reads)
    # affine gaps: one consolidated insertion event (linear-gap tracebacks
    # may split a multi-base insertion into score-equivalent adjacent events)
    eng = VariantPrepEngine(ref, cfg, gapped=True, min_depth=3,
                            alt_fraction=0.2, gap_model="affine")
    res = eng.process_file(path)
    assert any(c.alt_base == "<INS>" for c in res.candidates)
    res = eng.genotype_candidates(path, res)
    called = [c for c in res.candidates
              if c.gt is not None and len(c.alt_base) > 1
              and not c.alt_base.startswith("<")]
    assert called, "insertion should be inferred and genotyped"
    c = called[0]
    assert c.pos == anchor
    assert c.ref_base == chr(ref[anchor])
    assert c.alt_base == c.ref_base + ins.decode()
    assert c.gt == "1/1" and c.gl[2] > c.gl[0]

    # VCF carries the explicit inserted allele
    vcf_path = str(tmp_path / "ins.vcf")
    write_candidates_vcf(vcf_path, res)
    assert f"\t{c.ref_base}\t{c.alt_base}\t" in open(vcf_path).read()


def test_variant_prep_checkpoint_file_mismatch_refuses(tmp_path, rng, cfg,
                                                       ref_and_reads):
    ref, reads = ref_and_reads
    p1 = str(tmp_path / "a.fastq.gz")
    p2 = str(tmp_path / "b.fastq.gz")
    fastq.write_fastq(p1, [r for _, r in reads])
    fastq.write_fastq(p2, [r for _, r in reads])
    ckpt = str(tmp_path / "c.npz")
    VariantPrepEngine(ref, cfg).process_file(p1, checkpoint_path=ckpt,
                                             checkpoint_every=1)
    with pytest.raises(ValueError, match="file_path"):
        VariantPrepEngine(ref, cfg).process_file(p2, checkpoint_path=ckpt,
                                                 checkpoint_every=1)


def test_fasta_header_whitespace_only(tmp_path):
    p = tmp_path / "odd.fa"
    p.write_bytes(b"> \nACGT\n>chr2 desc\nTTTT\n")
    recs = fasta.read_fasta(str(p))
    assert recs == {"": b"ACGT", "chr2": b"TTTT"}


def test_complementarity_unequal_lanes_surfaced(tmp_path, rng, cfg):
    r1 = [random_dna(rng, 40) for _ in range(20)]
    r2 = [revcomp(r) for r in r1[:13]]  # 7 unpaired R1 reads
    f1, f2 = str(tmp_path / "u1.fastq.gz"), str(tmp_path / "u2.fastq.gz")
    fastq.write_fastq(f1, r1)
    fastq.write_fastq(f2, r2)
    logs = []
    res = ComplementarityEngine(cfg, mode="sw").analyze_lane_pair(
        f1, f2, progress=logs.append)
    assert res.pairs == 13 and res.unpaired_reads == 7
    assert res.perfect_pairs == 13
    assert any("unpaired" in line for line in logs)


def test_variant_prep_multi_file_sample(tmp_path, rng, cfg, ref_and_reads):
    ref, reads = ref_and_reads
    half = len(reads) // 2
    p1, p2 = str(tmp_path / "s1.fastq.gz"), str(tmp_path / "s2.fastq.gz")
    fastq.write_fastq(p1, [r for _, r in reads[:half]])
    fastq.write_fastq(p2, [r for _, r in reads[half:]])
    pall = str(tmp_path / "all.fastq.gz")
    fastq.write_fastq(pall, [r for _, r in reads])
    multi = VariantPrepEngine(ref, cfg).process_file([p1, p2])
    single = VariantPrepEngine(ref, cfg).process_file(pall)
    assert multi.total_reads == single.total_reads
    assert (multi.pileup == single.pileup).all()


def test_variant_prep_multi_file_sam(tmp_path, rng, cfg, ref_and_reads):
    ref, reads = ref_and_reads
    half = len(reads) // 2
    p1, p2 = str(tmp_path / "m1.fastq.gz"), str(tmp_path / "m2.fastq.gz")
    fastq.write_fastq(p1, [r for _, r in reads[:half]])
    fastq.write_fastq(p2, [r for _, r in reads[half:]])
    sam = str(tmp_path / "multi.sam")
    res = VariantPrepEngine(ref, cfg, gapped=True).process_file(
        [p1, p2], sam_out=sam)
    assert res.total_reads == len(reads)
    records = [l for l in open(sam) if not l.startswith("@")]
    assert len(records) == len(reads)


def test_map_reads_both_matches_two_pass(rng):
    """_map_reads_both (fused fwd+rc probe-key mapper) is bit-identical to
    the two-pass composition _map_reads(codes) + _map_reads(_revcomp_codes):
    same anchors and mapped flags on both strands, including reads with Ns,
    short reads, and unmappable reads."""
    import jax.numpy as jnp

    from mini_parallel.models.variant_prep import (
        SEED_K, ReferenceIndex, _map_reads, _map_reads_both, _revcomp_codes)
    from mini_parallel.ops import encode
    from tests.conftest import random_dna

    ref = random_dna(rng, 5000)
    index = ReferenceIndex(ref)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(64):
        s = int(rng.integers(0, 5000 - 80))
        r = bytearray(ref[s:s + 80])
        if i % 4 == 1:  # rc-strand read
            r = bytearray(bytes(r).translate(comp)[::-1])
        if i % 4 == 2:  # sprinkle Ns (kills seeds covering them)
            for p in rng.integers(0, len(r), size=3):
                r[int(p)] = ord("N")
        if i % 4 == 3:  # unrelated / short / tiny
            r = bytearray(random_dna(rng, int(rng.integers(4, 70))))
        reads.append(bytes(r))
    reads.append(b"")  # empty read
    arr, lens = encode.pad_batch(reads, pad_to=80,
                                 pad_value=int(encode.PAD_A))
    codes = encode.ascii_to_code(jnp.asarray(arr))
    lens_j = jnp.asarray(lens)

    sf0, mf0 = _map_reads(codes, lens_j, index.sorted_keys,
                          index.sorted_pos, SEED_K)
    rc = _revcomp_codes(codes, lens_j)
    sr0, mr0 = _map_reads(rc, lens_j, index.sorted_keys,
                          index.sorted_pos, SEED_K)
    sf1, mf1, sr1, mr1 = _map_reads_both(
        codes, lens_j, index.sorted_keys, index.sorted_pos, SEED_K)
    np.testing.assert_array_equal(np.asarray(mf0), np.asarray(mf1))
    np.testing.assert_array_equal(np.asarray(sf0), np.asarray(sf1))
    np.testing.assert_array_equal(np.asarray(mr0), np.asarray(mr1))
    np.testing.assert_array_equal(np.asarray(sr0), np.asarray(sr1))
    assert np.asarray(mf1).sum() > 10  # the fixture really maps reads
    assert np.asarray(mr1).sum() > 10
