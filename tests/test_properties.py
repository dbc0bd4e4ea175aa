"""Cross-cutting property tests (SURVEY.md §4's implied test strategy)."""

import numpy as np
import pytest

from mini_parallel.io import fastq
from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.models.kmer_model import KmerEngine
from mini_parallel.utils.config import Config
from tests.conftest import random_dna


@pytest.fixture
def lane(tmp_path, rng):
    reads = [random_dna(rng, int(rng.integers(30, 150))) for _ in range(37)]
    path = str(tmp_path / "prop.fastq.gz")
    fastq.write_fastq(path, reads)
    return path, reads


def test_sw_total_invariant_under_chunk_size(lane):
    # per-read self-SW sum must not depend on how reads are chunked
    path, reads = lane
    totals = []
    for cs in (5, 16, 100):
        eng = AlignmentEngine(Config(chunk_size_reads=cs, read_pad=152), mode="sw")
        totals.append(eng.self_align_file(path).score)
    assert totals[0] == totals[1] == totals[2] == sum(2 * len(r) for r in reads)


def test_kmer_counts_invariant_under_chunk_size(lane):
    path, reads = lane
    results = []
    for cs in (4, 11, 64):
        eng = KmerEngine(Config(chunk_size_reads=cs, read_pad=152), k=21)
        res = eng.count_file(path)
        counts = res.counts if isinstance(res.counts, dict) else dict(res.counts)
        results.append((res.total_kmers, res.distinct_kmers, counts))
    assert results[0] == results[1] == results[2]


def test_parity_chunk_dependence_matches_reference_semantics(lane):
    # kadane parity: score = 2 per chunk with >=1000 concat bases — chunk-size
    # DEPENDENT by the reference's definition. Check the formula directly.
    path, reads = lane
    for cs in (5, 16):
        eng = AlignmentEngine(Config(chunk_size_reads=cs, read_pad=152),
                              mode="kadane")
        res = eng.self_align_file(path)
        expect = 0
        for i in range(0, len(reads), cs):
            if sum(len(r) for r in reads[i:i + cs]) >= 1000:
                expect += 2
        assert res.score == expect, cs


def test_sw_symmetry(rng):
    # SW(a, b) == SW(b, a)
    from mini_parallel.ops import encode, sw
    import jax.numpy as jnp

    ra = [random_dna(rng, int(rng.integers(5, 60))) for _ in range(10)]
    rb = [random_dna(rng, int(rng.integers(5, 60))) for _ in range(10)]
    A, _ = encode.pad_batch(ra, pad_to=64, pad_value=int(encode.PAD_A))
    B, _ = encode.pad_batch(rb, pad_to=64, pad_value=int(encode.PAD_B))
    A2, _ = encode.pad_batch(rb, pad_to=64, pad_value=int(encode.PAD_A))
    B2, _ = encode.pad_batch(ra, pad_to=64, pad_value=int(encode.PAD_B))
    f = np.asarray(sw.sw_score_batch(jnp.asarray(A), jnp.asarray(B)))
    g = np.asarray(sw.sw_score_batch(jnp.asarray(A2), jnp.asarray(B2)))
    assert (f == g).all()


def test_sw_substring_identity(rng):
    # a substring aligned against its source scores 2*len(substring)
    from mini_parallel.ops import sw

    s = random_dna(rng, 200)
    sub = s[40:90]
    assert sw.sw_score_numpy(sub, s) == 2 * len(sub)
    assert sw.sw_score_pair(sub, s) == 2 * len(sub)


def test_revcomp_involution_engine(rng):
    from mini_parallel.models.complementarity import _revcomp_batch

    reads = [random_dna(rng, 33) for _ in range(5)]
    assert _revcomp_batch(_revcomp_batch(reads)) == reads
