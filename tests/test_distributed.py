import numpy as np
import pytest

from mini_parallel.io import fastq
from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.parallel import distributed
from mini_parallel.utils.config import Config
from tests.conftest import random_dna


def test_shard_files_round_robin():
    files = [f"f{i}" for i in range(16)]
    shards = [distributed.shard_files(files, p, 3) for p in range(3)]
    assert sorted(sum(shards, [])) == sorted(files)  # exact partition
    assert [len(s) for s in shards] == [6, 5, 5]
    assert shards[0][:2] == ["f0", "f3"]  # interleaved, not block-split


def test_shard_files_single_process_identity():
    files = ["a", "b"]
    assert distributed.shard_files(files, 0, 1) == files


def test_merge_totals_single_process():
    t = distributed.DistributedTotals(2, 10, 100, 4, 1.5)
    assert distributed.merge_totals(t) == t


def test_distributed_wgs_single_process(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(wgs_data_dir=str(tmp_path), sample_id="D", lanes=2,
                 reads_per_lane=1, chunk_size_reads=5, read_pad=64)
    reads = [random_dna(rng, 300) for _ in range(10)]
    for lane in (1, 2):
        fastq.write_fastq(str(tmp_path / f"D_L{lane:03d}_R1_001.fastq.gz"), reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    results, merged = distributed.process_full_wgs_distributed(
        eng, cfg, checkpoint_dir=str(tmp_path), echo=lambda *_: None
    )
    assert merged.files == 2
    assert merged.reads == 20
    assert merged.bases == 6000
    assert merged.score == 8


def test_plan_work_skewed_lanes_within_15pct():
    """SURVEY §7 hard part: 10:1 lane skew. Round-robin's makespan is ~2x
    the even split; the size-aware plan must land within 15% of ideal."""
    sizes = {"big": 10_000, "s1": 1_000, "s2": 1_000, "s3": 1_000}
    files = list(sizes)
    plan = distributed.plan_work(files, 2, sizes=sizes)
    assert plan.shared == ["big"]  # bigger than ideal share -> strided
    # every file appears exactly once across the plan
    assert sorted(sum(plan.exclusive, []) + plan.shared) == sorted(files)
    ideal = sum(sizes.values()) / 2
    assert plan.makespan_bytes(sizes) <= 1.15 * ideal
    # round-robin for comparison: pid0 gets big+s2 = 11000 = 1.69x ideal
    rr = [sum(sizes[f] for f in distributed.shard_files(files, p, 2))
          for p in range(2)]
    assert max(rr) > 1.5 * ideal


def test_plan_work_lpt_beats_round_robin_without_sharing():
    sizes = {f"f{i}": s for i, s in
             enumerate([5, 5, 4, 4, 3, 3, 2, 2, 1, 1])}
    files = list(sizes)
    plan = distributed.plan_work(files, 2, sizes=sizes)
    assert plan.shared == []
    loads = [sum(sizes[f] for f in shard) for shard in plan.exclusive]
    assert max(loads) == 15  # perfect split of 30
    # identical plan on every "process" (determinism contract)
    assert distributed.plan_work(files, 2, sizes=sizes) == plan


def test_chunk_stride_partitions_exactly(tmp_path, rng):
    """Sum of the two stripes == the whole file, chunks balanced within 1."""
    cfg = Config(wgs_data_dir=str(tmp_path), sample_id="S", lanes=1,
                 reads_per_lane=1, chunk_size_reads=4, read_pad=64)
    path = str(tmp_path / "S_L001_R1_001.fastq.gz")
    reads = [random_dna(rng, 300) for _ in range(37)]  # 10 chunks, ragged
    fastq.write_fastq(path, reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    full = eng.self_align_file(path)
    stripes = [eng.self_align_file(path, chunk_stride=(p, 2))
               for p in range(2)]
    assert sum(s.score for s in stripes) == full.score
    assert sum(s.total_reads for s in stripes) == full.total_reads
    assert sum(s.total_bases for s in stripes) == full.total_bases
    assert sum(s.chunks for s in stripes) == full.chunks
    assert abs(stripes[0].chunks - stripes[1].chunks) <= 1


def test_chunk_stride_resume_owned_index_space(tmp_path, rng):
    """resume.chunks_done counts OWNED chunks under chunk_stride; resuming
    mid-stripe must not rescore already-counted chunks."""
    cfg = Config(wgs_data_dir=str(tmp_path), sample_id="S", lanes=1,
                 reads_per_lane=1, chunk_size_reads=4, read_pad=64)
    path = str(tmp_path / "S_L001_R1_001.fastq.gz")
    reads = [random_dna(rng, 300) for _ in range(41)]  # 11 chunks
    fastq.write_fastq(path, reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    full = eng.self_align_file(path, chunk_stride=(1, 2))

    class Partial:
        pass

    # simulate a crash after 2 owned chunks: the resumed run must produce
    # the REMAINING owned chunks so partial + rest == full stripe
    head = eng.self_align_file(path, chunk_stride=(1, 2))
    # recompute the first two owned chunks' contribution by resuming at 2
    p = Partial()
    p.chunks_done, p.score, p.total_bases, p.total_reads = 2, 0, 0, 0
    p.processing_time_ms = 0.0
    tail = eng.self_align_file(path, chunk_stride=(1, 2), resume=p)
    assert tail.chunks == full.chunks  # seeded 2 + remaining owned
    assert tail.total_reads < full.total_reads  # head chunks not rescored
    assert full.chunks == 5  # owned chunks of stripe (1,2) over 11


def test_stripe_with_retries_recovers(tmp_path, rng, monkeypatch):
    """A transient failure mid-stripe resumes from the in-memory chunk
    checkpoint and completes exactly."""
    from mini_parallel.parallel.distributed import _stripe_with_retries

    cfg = Config(wgs_data_dir=str(tmp_path), sample_id="S", lanes=1,
                 reads_per_lane=1, chunk_size_reads=4, read_pad=64)
    path = str(tmp_path / "S_L001_R1_001.fastq.gz")
    reads = [random_dna(rng, 300) for _ in range(40)]
    fastq.write_fastq(path, reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    want = eng.self_align_file(path, chunk_stride=(0, 2))

    calls = {"n": 0}
    orig = AlignmentEngine.self_align_file

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            kw2 = dict(kw)
            kw2["checkpoint_every"] = 1  # checkpoint every owned chunk
            try:
                # run a couple of chunks, then die
                count = {"c": 0}
                inner_cb = kw2.get("on_checkpoint")

                def boom(res):
                    inner_cb(res)
                    count["c"] += 1
                    if count["c"] == 2:
                        raise RuntimeError("transient")

                kw2["on_checkpoint"] = boom
                return orig(self, *a, **kw2)
            finally:
                pass
        return orig(self, *a, **kw)

    monkeypatch.setattr(AlignmentEngine, "self_align_file", flaky)
    got = _stripe_with_retries(eng, path, 0, 2, retries=1,
                               echo=lambda *_: None)
    assert got.score == want.score
    assert got.total_reads == want.total_reads
    assert calls["n"] == 2


def test_stripe_checkpoint_survives_process_restart(tmp_path, rng, monkeypatch):
    """Stripe progress persists via CheckpointState: a host CRASH (fresh
    process, in-memory partial lost) resumes from the on-disk owned-chunk
    checkpoint instead of re-processing the stripe (advisor r2 finding)."""
    from mini_parallel.parallel.distributed import _stripe_with_retries
    from mini_parallel.utils.checkpoint import CheckpointState

    cfg = Config(wgs_data_dir=str(tmp_path), sample_id="S", lanes=1,
                 reads_per_lane=1, chunk_size_reads=4, read_pad=64)
    path = str(tmp_path / "S_L001_R1_001.fastq.gz")
    reads = [random_dna(rng, 300) for _ in range(40)]
    fastq.write_fastq(path, reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    want = eng.self_align_file(path, chunk_stride=(0, 2))

    state = CheckpointState(run_id="stripe_test", total_files=1,
                            directory=str(tmp_path))
    orig = AlignmentEngine.self_align_file

    def crashing(self, *a, **kw):
        kw2 = dict(kw)
        kw2["checkpoint_every"] = 1
        inner_cb = kw2.get("on_checkpoint")
        count = {"c": 0}

        def boom(res):
            inner_cb(res)
            count["c"] += 1
            if count["c"] == 2:
                raise RuntimeError("host died")

        kw2["on_checkpoint"] = boom
        return orig(self, *a, **kw2)

    monkeypatch.setattr(AlignmentEngine, "self_align_file", crashing)
    try:
        _stripe_with_retries(eng, path, 0, 2, retries=0,
                             echo=lambda *_: None, state=state, file_index=0)
    except RuntimeError:
        pass
    monkeypatch.setattr(AlignmentEngine, "self_align_file", orig)

    # "restart": load the state fresh from disk, no in-memory partial
    state2 = CheckpointState.load("stripe_test", str(tmp_path))
    assert state2 is not None
    assert state2.get_file(0).chunks_done == 2
    got = _stripe_with_retries(eng, path, 0, 2, retries=0,
                               echo=lambda *_: None, state=state2,
                               file_index=0)
    assert got.score == want.score
    assert got.total_reads == want.total_reads
    assert got.chunks == want.chunks
