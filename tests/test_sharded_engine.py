"""Mesh-sharded engine must produce identical results to the local engine."""

import numpy as np
import pytest

from mini_parallel.io import fastq
from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.parallel.mesh import make_mesh
from mini_parallel.utils.config import Config
from tests.conftest import random_dna


@pytest.fixture
def lane(tmp_path, rng):
    reads = [random_dna(rng, 300) for _ in range(26)]  # odd count: pad rows
    path = str(tmp_path / "lane.fastq.gz")
    fastq.write_fastq(path, reads)
    return path


@pytest.mark.parametrize("mode", ["kadane", "contiguous", "sw"])
def test_sharded_matches_local(lane, mode, mesh8):
    cfg = Config(chunk_size_reads=4, read_pad=320)
    local = AlignmentEngine(cfg, mode=mode).self_align_file(lane)
    sharded = AlignmentEngine(cfg, mode=mode, mesh=mesh8).self_align_file(lane)
    assert sharded.score == local.score
    assert sharded.total_reads == local.total_reads
    assert sharded.total_bases == local.total_bases


def test_sharded_small_batch_padding(tmp_path, rng, mesh8):
    # fewer chunks than devices: pad rows must not contribute
    reads = [random_dna(rng, 1200)]
    path = str(tmp_path / "one.fastq.gz")
    fastq.write_fastq(path, reads)
    cfg = Config(chunk_size_reads=1, read_pad=2048)
    local = AlignmentEngine(cfg, mode="kadane").self_align_file(path)
    sharded = AlignmentEngine(cfg, mode="kadane", mesh=mesh8).self_align_file(path)
    assert sharded.score == local.score == 2


@pytest.mark.parametrize("mode", ["sw", "kadane", "sw-affine"])
def test_sharded_pair_scores_match_local(mode, mesh8, rng):
    """score_read_batch over a mesh == unsharded, incl. non-multiple batch."""
    reads_a = [random_dna(rng, int(rng.integers(20, 40))) for _ in range(21)]
    reads_b = [random_dna(rng, int(rng.integers(20, 40))) for _ in range(21)]
    cfg = Config(chunk_size_reads=8, read_pad=48)
    local = AlignmentEngine(cfg, mode=mode).score_read_batch(reads_a, reads_b)
    sharded = AlignmentEngine(cfg, mode=mode, mesh=mesh8).score_read_batch(
        reads_a, reads_b)
    np.testing.assert_array_equal(np.asarray(sharded), local)
