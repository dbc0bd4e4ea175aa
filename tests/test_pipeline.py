"""End-to-end pipeline tests: engine + orchestrator + checkpoint + CLI,
on tiny FASTQ fixtures, validated against the bit-exact reference emulation."""

import json
import os

import numpy as np
import pytest

from mini_parallel.io import fastq
from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.models.wgs import process_full_wgs_dataset
from mini_parallel.ops import kadane, sw
from mini_parallel.utils.checkpoint import CheckpointState, deterministic_run_id
from mini_parallel.utils.config import Config
from tests.conftest import random_dna


@pytest.fixture
def cfg(tmp_path):
    return Config(
        wgs_data_dir=str(tmp_path), sample_id="TEST", lanes=2, reads_per_lane=1,
        chunk_size_reads=5, read_pad=64,
    )


def make_lane(tmp_path, name, reads):
    path = str(tmp_path / name)
    fastq.write_fastq(path, reads)
    return path


def test_direct_mode_parity_vs_reference():
    eng = AlignmentEngine(Config(chunk_size_reads=10), mode="kadane")
    for a, b in [("ACGT", "ACGA"), ("AAAA", "TTTT"), ("", "ACGT"), ("A", "A")]:
        assert eng.score_strings(a, b) == kadane.reference_align_score(a, b)


def test_direct_mode_sw():
    eng = AlignmentEngine(Config(chunk_size_reads=10), mode="sw")
    assert eng.score_strings("ACGT", "ACGT") == 8
    assert eng.score_strings("ACGTT", "ACGAT") == sw.sw_score_numpy("ACGTT", "ACGAT")


def test_self_align_file_parity(tmp_path, rng, cfg):
    # 12 reads of 100bp, chunks of 5 -> chunks of sizes 5,5,2;
    # concat lengths 500,500,200 -> last chunk <1000 scores 0 (aligner.rs:366).
    reads = [random_dna(rng, 100) for _ in range(12)]
    path = make_lane(tmp_path, "TEST_L001_R1_001.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    res = eng.self_align_file(path)
    # per-chunk reference score: gpu_align(concat, concat)
    expect = 0
    for i in range(0, 12, 5):
        concat = b"".join(reads[i : i + 5])
        if len(concat) >= 1000:
            expect += kadane.reference_align_score(concat, concat)
    assert res.score == expect
    assert res.total_reads == 12
    assert res.total_bases == 1200
    assert res.chunks == 3


def test_self_align_file_large_chunks_score_two_each(tmp_path, rng, cfg):
    reads = [random_dna(rng, 300) for _ in range(10)]  # concat 1500 >= 1000
    path = make_lane(tmp_path, "big.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    res = eng.self_align_file(path)
    assert res.chunks == 2 and res.score == 4  # 2 per qualifying chunk


def test_self_align_sw_mode(tmp_path, rng, cfg):
    reads = [random_dna(rng, 50) for _ in range(4)]
    path = make_lane(tmp_path, "sw.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="sw")
    res = eng.self_align_file(path)
    assert res.score == sum(2 * len(r) for r in reads)  # self-SW = 2*len


def test_pair_align_files_cross_product_parity(tmp_path, rng, cfg):
    r1 = [random_dna(rng, 40) for _ in range(7)]
    r2 = [random_dna(rng, 40) for _ in range(6)]
    f1 = make_lane(tmp_path, "p1.fastq.gz", r1)
    f2 = make_lane(tmp_path, "p2.fastq.gz", r2)
    eng = AlignmentEngine(cfg, mode="kadane")
    res = eng.pair_align_files(f1, f2)
    expect = 0  # aligner.rs:390-398 cross product of chunks (size 5)
    chunks1 = [r1[:5], r1[5:]]
    chunks2 = [r2[:5], r2[5:]]
    for c1 in chunks1:
        for c2 in chunks2:
            expect += kadane.reference_align_score(b"".join(c1), b"".join(c2))
    assert res.score == expect
    assert res.bases1 == sum(map(len, r1)) and res.bases2 == sum(map(len, r2))


def test_full_wgs_with_checkpoint_resume(tmp_path, rng, cfg, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = [random_dna(rng, 300) for _ in range(10)]
    for lane in (1, 2):
        make_lane(tmp_path, f"TEST_L{lane:03d}_R1_001.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    out = []
    results = process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                       results_dir=str(tmp_path / "benchmark_results"),
                                       echo=out.append)
    assert len(results) == 2
    assert all(r.score == 4 for r in results)
    # measured drain-time (device seconds) must be populated, not null —
    # the fix for the reference's hardcoded 25% util (benchmark.rs:159-163)
    assert all(r.drain_seconds > 0 for r in results)
    import glob
    import json

    run_files = glob.glob(str(tmp_path / "benchmark_results" / "run_*.json"))
    payload = json.load(open(sorted(run_files)[-1]))
    payload = payload[-1] if isinstance(payload, list) else payload
    assert payload["device_seconds"] is not None
    assert payload["device_duty_cycle"] is not None

    run_id = deterministic_run_id(cfg.sample_id, cfg.wgs_file_list(),
                              "kadane", chunk_size=cfg.chunk_size_reads)
    state = CheckpointState.load(run_id, str(tmp_path))
    assert state is not None and state.completed_files == 2

    # resume: both files skipped, results reconstructed from checkpoint
    out2 = []
    results2 = process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                        results_dir=str(tmp_path / "benchmark_results"),
                                        echo=out2.append)
    assert len(results2) == 2 and all(r.score == 4 for r in results2)
    assert sum("Skipping file" in line for line in out2) == 2

    # benchmark JSON written with real totals for the run that did the work
    legacy = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert legacy[-2]["total_reads"] == 20
    assert legacy[-2]["total_bases"] == 6000
    assert legacy[-2]["total_score"] == 8
    # the pure-resume run did NO new work and must say so (a resumed run's
    # throughput is this run's deltas, not prior work over this run's time)
    assert legacy[-1]["total_reads"] == 0


def test_self_align_file_chunk_resume_bit_exact(tmp_path, rng, cfg):
    # 20 reads / chunk 5 -> 4 chunks of 1500 bases each
    reads = [random_dna(rng, 300) for _ in range(20)]
    path = make_lane(tmp_path, "resume.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    clean = eng.self_align_file(path)

    # capture a mid-file checkpoint every chunk, resume from chunk 2
    import copy

    snaps = []
    eng.self_align_file(path, checkpoint_every=1,
                        on_checkpoint=lambda r: snaps.append(copy.copy(r)))
    assert [s.chunks for s in snaps] == [1, 2, 3, 4]
    mid = snaps[1]
    mid.chunks_done = mid.chunks  # FileCheckpoint-shaped resume point
    resumed = eng.self_align_file(path, resume=mid)
    assert resumed.score == clean.score
    assert resumed.total_reads == clean.total_reads == 20
    assert resumed.total_bases == clean.total_bases == 6000
    assert resumed.chunks == clean.chunks == 4


@pytest.mark.parametrize("mode,packed", [("sw", True), ("sw", False),
                                         ("sw-affine", True)])
def test_self_align_file_chunk_resume_sw_modes(tmp_path, rng, cfg, mode, packed):
    import copy
    import dataclasses

    cfg = dataclasses.replace(cfg, packed_transfer=packed)
    reads = [random_dna(rng, 64) for _ in range(20)]
    path = make_lane(tmp_path, "resume_sw.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode=mode)
    clean = eng.self_align_file(path)

    snaps = []
    eng.self_align_file(path, checkpoint_every=1,
                        on_checkpoint=lambda r: snaps.append(copy.copy(r)))
    assert [s.chunks for s in snaps] == [1, 2, 3, 4]
    mid = snaps[2]
    mid.chunks_done = mid.chunks
    assert mid.score == sum(2 * len(r) for r in reads[:15])  # drained partials
    resumed = eng.self_align_file(path, resume=mid)
    assert resumed.score == clean.score == sum(2 * len(r) for r in reads)
    assert resumed.total_reads == 20 and resumed.chunks == 4


def test_full_wgs_mid_file_failure_resumes_from_chunk(tmp_path, cfg, rng,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = [random_dna(rng, 300) for _ in range(20)]  # 4 chunks per file
    for lane in (1, 2):
        make_lane(tmp_path, f"TEST_L{lane:03d}_R1_001.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")

    real_flat = fastq.iter_flat_chunks

    def dying_iter(path, chunk_size, **kw):
        for i, chunk in enumerate(real_flat(path, chunk_size, **kw)):
            if i == 3:  # die mid-file, after the chunk-2 checkpoint
                raise RuntimeError("injected disk error")
            yield chunk

    monkeypatch.setattr(fastq, "iter_flat_chunks", dying_iter)
    with pytest.raises(RuntimeError, match="File 1 failed"):
        process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                 echo=lambda *_: None,
                                 checkpoint_every_chunks=2)
    run_id = deterministic_run_id(cfg.sample_id, cfg.wgs_file_list(),
                              "kadane", chunk_size=cfg.chunk_size_reads)
    state = CheckpointState.load(run_id, str(tmp_path))
    partial = state.get_file(0)
    assert partial is not None and not partial.completed
    assert partial.chunks_done == 2 and partial.total_reads == 10
    assert partial.score == 4  # 2 per scored chunk

    monkeypatch.setattr(fastq, "iter_flat_chunks", real_flat)
    out = []
    results = process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                       echo=out.append,
                                       checkpoint_every_chunks=2)
    assert any("Resuming file 1/2 from chunk 2" in line for line in out)
    assert [r.score for r in results] == [8, 8]  # bit-exact vs clean run
    assert all(r.total_reads == 20 for r in results)
    state = CheckpointState.load(run_id, str(tmp_path))
    assert state.completed_files == 2


def test_full_wgs_failure_saves_partial_checkpoint(tmp_path, cfg, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_lane(tmp_path, "TEST_L001_R1_001.fastq.gz", [random_dna(rng, 300)] * 10)
    # second lane file missing -> failure after first file completes
    eng = AlignmentEngine(cfg, mode="kadane")
    with pytest.raises(RuntimeError, match="File 2 failed"):
        process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                 echo=lambda *_: None)
    run_id = deterministic_run_id(cfg.sample_id, cfg.wgs_file_list(),
                              "kadane", chunk_size=cfg.chunk_size_reads)
    state = CheckpointState.load(run_id, str(tmp_path))
    assert state is not None
    assert state.is_file_completed(0) and not state.is_file_completed(1)


def test_cli_direct_mode(capsys):
    from mini_parallel.cli import main

    rc = main(["-1", "ACGT", "-2", "ACGA", "--allow-cpu"])
    assert rc == 0
    assert "Alignment score: 2" in capsys.readouterr().out


def test_cli_direct_sw_mode(capsys):
    from mini_parallel.cli import main

    rc = main(["-1", "ACGT", "-2", "ACGT", "--mode", "sw", "--allow-cpu"])
    assert rc == 0
    assert "Alignment score: 8" in capsys.readouterr().out


def test_cli_test_wgs(tmp_path, rng, monkeypatch, capsys):
    reads = [random_dna(rng, 50) for _ in range(3)]
    for r in (1, 2):
        fastq.write_fastq(str(tmp_path / f"TEST_L001_R{r}_001.fastq.gz"), reads)
    monkeypatch.setenv("WGS_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("WGS_SAMPLE_ID", "TEST")
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "10")
    from mini_parallel.cli import main

    rc = main(["--test-wgs", "--allow-cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count("150 bases") == 2


def test_cli_pair_files(tmp_path, rng, monkeypatch, capsys):
    f1 = make_lane(tmp_path, "a.fastq.gz", [random_dna(rng, 30)] * 4)
    f2 = make_lane(tmp_path, "b.fastq.gz", [random_dna(rng, 30)] * 4)
    monkeypatch.setenv("GPU_CHUNK_SIZE_READS", "10")
    from mini_parallel.cli import main

    rc = main(["--files", "-1", f1, "-2", f2, "--allow-cpu"])
    assert rc == 0
    assert "Alignment score:" in capsys.readouterr().out


def test_cli_no_args_prints_help(capsys):
    from mini_parallel.cli import main

    assert main([]) == 2


def test_self_align_skips_failed_chunks(tmp_path, rng, cfg, monkeypatch):
    # aligner.rs:284-287 parity: a chunk that blows the device budget is
    # logged and skipped (scores 0); the rest of the file still scores.
    from mini_parallel.utils import system_info

    reads = [random_dna(rng, 300) for _ in range(15)]           # 3 good chunks
    monster_chunk = [random_dna(rng, 300_000)] + [random_dna(rng, 300)] * 4
    path = make_lane(tmp_path, "oversize.fastq.gz", reads + monster_chunk)

    info = system_info.SystemInfo(hbm_bytes_limit=3 * 1024 * 1024)
    monkeypatch.setattr(
        "mini_parallel.utils.system_info.get_system_info", lambda: info
    )
    eng = AlignmentEngine(cfg, mode="kadane")
    logs = []
    res = eng.self_align_file(path, progress=logs.append)
    assert res.failed_chunks == 1
    assert res.score == 6  # 2 per good chunk; monster chunk scored 0
    assert res.chunks == 4 and res.total_reads == 20
    assert any("Alignment failed for chunk" in line for line in logs)


def test_device_memory_guard(monkeypatch):
    # mirror of aligner.rs:436-456: oversized launches error descriptively
    from mini_parallel.models import alignment
    from mini_parallel.utils import system_info

    info = system_info.SystemInfo(hbm_bytes_limit=3 * 1024 * 1024)  # tiny HBM
    monkeypatch.setattr(alignment, "check_device_budget",
                        alignment.check_device_budget)  # keep real fn
    monkeypatch.setattr(
        "mini_parallel.utils.system_info.get_system_info", lambda: info
    )
    with pytest.raises(alignment.SequenceTooLarge, match="Batch too large"):
        alignment.check_device_budget(10 * 1024 * 1024)
    alignment.check_device_budget(100)  # under budget: fine
    # unknown HBM: guard is a no-op
    info2 = system_info.SystemInfo(hbm_bytes_limit=None)
    monkeypatch.setattr(
        "mini_parallel.utils.system_info.get_system_info", lambda: info2
    )
    alignment.check_device_budget(1 << 40)


def test_full_wgs_retries_recover_transient_failure(tmp_path, cfg, rng,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    reads = [random_dna(rng, 300) for _ in range(20)]  # 4 chunks per file
    for lane in (1, 2):
        make_lane(tmp_path, f"TEST_L{lane:03d}_R1_001.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")

    real_flat = fastq.iter_flat_chunks
    fails = {"left": 1}  # transient: fail once, then heal

    def flaky_iter(path, chunk_size, **kw):
        for i, chunk in enumerate(real_flat(path, chunk_size, **kw)):
            if i == 3 and fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("transient device error")
            yield chunk

    monkeypatch.setattr(fastq, "iter_flat_chunks", flaky_iter)
    out = []
    results = process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                       echo=out.append,
                                       checkpoint_every_chunks=2, retries=2)
    assert any("attempt 1 failed" in line and "retrying" in line
               for line in out)
    assert [r.score for r in results] == [8, 8]  # bit-exact despite the crash
    assert all(r.total_reads == 20 for r in results)

    # retries=0 keeps the reference's abort semantics
    fails["left"] = 1
    run_id = deterministic_run_id(cfg.sample_id, cfg.wgs_file_list(),
                              "kadane", chunk_size=cfg.chunk_size_reads)
    os.remove(str(tmp_path / f"checkpoint_{run_id}.json"))
    with pytest.raises(RuntimeError, match="File 1 failed"):
        process_full_wgs_dataset(eng, cfg, checkpoint_dir=str(tmp_path),
                                 echo=lambda *_: None,
                                 checkpoint_every_chunks=2, retries=0)


def test_warmup_seconds_charged_once_per_shape(tmp_path, cfg, rng):
    """First dispatch of each new jit shape blocks into warmup_seconds;
    a second file with identical shapes charges none (the compile-wait /
    steady-state split behind steady_state_duty_cycle)."""
    reads = [random_dna(rng, 300) for _ in range(20)]
    p1 = make_lane(tmp_path, "TEST_L001_R1_001.fastq.gz", reads)
    p2 = make_lane(tmp_path, "TEST_L002_R1_001.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    r1 = eng.self_align_file(p1)
    assert r1.warmup_seconds > 0  # first shape ever -> compile charged here
    r2 = eng.self_align_file(p2)
    assert r2.warmup_seconds == 0.0  # same shapes, engine already warm
    assert r1.score == r2.score


def test_score_accumulator_overflow_drain_exact(tmp_path, cfg, rng,
                                                monkeypatch):
    """The device-side score accumulator must fold into the host total
    before its int32 bound can wrap (round-5 review finding). Forcing a
    tiny limit makes every batch take the safety-drain path; scores must
    be identical to the unforced run."""
    from mini_parallel.models import alignment as al

    reads = [random_dna(rng, 300) for _ in range(20)]
    path = str(tmp_path / "ov.fastq.gz")
    make_lane(tmp_path, "ov.fastq.gz", reads)
    eng = AlignmentEngine(cfg, mode="kadane")
    want = eng.self_align_file(path)
    monkeypatch.setattr(al, "_ACC_LIMIT", 1)  # every enqueue drains first
    got = AlignmentEngine(cfg, mode="kadane").self_align_file(path)
    assert got.score == want.score
    assert got.total_reads == want.total_reads
    eng_sw = AlignmentEngine(cfg, mode="sw")
    got_sw = eng_sw.self_align_file(path)
    monkeypatch.undo()
    want_sw = AlignmentEngine(cfg, mode="sw").self_align_file(path)
    assert got_sw.score == want_sw.score
