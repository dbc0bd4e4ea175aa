"""Affine-gap (Gotoh) SW: the batched scan vs NumPy golden, linear equivalence."""

import numpy as np
import jax.numpy as jnp
import pytest

from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.ops import encode, sw
from mini_parallel.utils.config import Config
from tests.conftest import random_dna


def _arrays(ra, rb, pad=64):
    a, _ = encode.pad_batch(ra, pad_to=pad, pad_value=int(encode.PAD_A))
    b, _ = encode.pad_batch(rb, pad_to=pad, pad_value=int(encode.PAD_B))
    return jnp.asarray(a), jnp.asarray(b)


def test_affine_golden_hand_cases():
    assert sw.sw_affine_numpy("ACGT", "ACGT") == 8
    # one 3-base gap: affine (open -2, ext -1) charges -2-3 = -5; linear -6.
    a, b = "AAAATTTCCCC", "AAAACCCC"
    assert sw.sw_affine_numpy(a, b) == 16 - 5
    assert sw.sw_score_numpy(a, b) == max(16 - 6, 8)  # linear


def test_affine_scan_matches_golden(rng):
    ra = [random_dna(rng, int(rng.integers(1, 60))) for _ in range(24)]
    rb = [random_dna(rng, int(rng.integers(1, 60))) for _ in range(24)]
    a, b = _arrays(ra, rb)
    scan = np.asarray(sw.sw_affine_batch(a, b))
    gold = np.array([sw.sw_affine_numpy(x, y) for x, y in zip(ra, rb)])
    assert (scan == gold).all()


def test_affine_linear_equivalence(rng):
    # gap_open=0, gap_extend=-2 must equal the linear-gap DP exactly
    ra = [random_dna(rng, 40) for _ in range(8)]
    rb = [random_dna(rng, 40) for _ in range(8)]
    a, b = _arrays(ra, rb)
    aff = np.asarray(sw.sw_affine_batch(a, b, gap_open=0, gap_extend=-2))
    lin = np.asarray(sw.sw_score_batch(a, b))
    assert (aff == lin).all()


def test_affine_custom_params(rng):
    ra, rb = [random_dna(rng, 50)], [random_dna(rng, 50)]
    a, b = _arrays(ra, rb)
    for open_, ext in [(-4, -1), (-1, -1), (-6, -2)]:
        got = int(sw.sw_affine_batch(a, b, gap_open=open_, gap_extend=ext)[0])
        gold = sw.sw_affine_numpy(ra[0], rb[0], gap_open=open_, gap_extend=ext)
        assert got == gold, (open_, ext)


def test_engine_sw_affine_mode():
    eng = AlignmentEngine(Config(chunk_size_reads=10), mode="sw-affine")
    assert eng.score_strings("ACGT", "ACGT") == 8
    assert eng.score_strings("AAAATTTCCCC", "AAAACCCC") == 11


def test_engine_sw_affine_sharded(tmp_path, rng, mesh8):
    from mini_parallel.io import fastq

    reads = [random_dna(rng, 80) for _ in range(10)]
    path = str(tmp_path / "aff.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=3, read_pad=96)
    local = AlignmentEngine(cfg, mode="sw-affine").self_align_file(path)
    shard = AlignmentEngine(cfg, mode="sw-affine", mesh=mesh8).self_align_file(path)
    assert local.score == shard.score == sum(2 * len(r) for r in reads)
