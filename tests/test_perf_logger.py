import json
import os
import time

from mini_parallel.utils.perf_logger import (
    SystemMonitors,
    summarize_monitor_logs,
    system_monitors,
)


def test_monitors_start_stop(tmp_path):
    with system_monitors(log_base=str(tmp_path / "logs")) as mon:
        assert mon.run_dir is not None
        time.sleep(1.2)  # let the device sampler tick once
    assert os.path.exists(os.path.join(mon.run_dir, "device_memory.jsonl"))
    # monitors are stopped (no leaked child processes)
    assert mon._procs == {}


def test_perf_record_monitor_spawned_and_optional(tmp_path, monkeypatch):
    # perf record is attempted by default (perf_logger.rs:152-156) and its
    # absence is logged gracefully; MPT_PERF_RECORD=0 disables the attempt
    m = SystemMonitors(log_base=str(tmp_path / "a"))
    d = m.start()
    m.stop()
    assert os.path.exists(os.path.join(d, "perf_record.log"))

    monkeypatch.setenv("MPT_PERF_RECORD", "0")
    m2 = SystemMonitors(log_base=str(tmp_path / "b"))
    d2 = m2.start()
    m2.stop()
    assert not os.path.exists(os.path.join(d2, "perf_record.log"))


def test_run_dirs_increment(tmp_path):
    base = str(tmp_path / "logs")
    m1 = SystemMonitors(log_base=base)
    d1 = m1.start()
    m1.stop()
    m2 = SystemMonitors(log_base=base)
    d2 = m2.start()
    m2.stop()
    assert d1.endswith("run_1") and d2.endswith("run_2")


def test_summarize_monitor_logs(tmp_path):
    d = str(tmp_path)
    (tmp_path / "vmstat.log").write_text(
        "procs memory\n"
        " r  b   swpd   free   buff  cache si so bi bo in cs us sy id wa st\n"
        " 1  0      0 800000 10000 20000  0  0  5 10 200 345 1 1 98 0 0\n"
        " 2  0      0 700000 10000 20000  0  0  5 10 300 999 2 1 97 0 0\n"
    )
    (tmp_path / "device_memory.jsonl").write_text(
        json.dumps({"t": 1, "0": {"bytes_in_use": 100, "peak_bytes_in_use": 5000}})
        + "\n"
    )
    out = summarize_monitor_logs(d)
    assert out["max_context_switches_per_s"] == 999.0
    assert out["min_free_memory_kb"] == 700000.0
    assert out["peak_device_bytes_in_use"] == 5000


def test_summarize_empty_dir(tmp_path):
    assert summarize_monitor_logs(str(tmp_path)) == {}


def test_summarize_queue_probe_utilization(tmp_path):
    """The latency-probe rows produce an honest busy-fraction estimate."""
    import json

    from mini_parallel.utils.perf_logger import summarize_monitor_logs

    rows = []
    # The probe BLOCKS the sampler, so a 100 s busy window is ONE sample
    # with a 100 s latency — counting samples would call this run ~20%
    # busy; time-weighting must call it ~96% busy (review round-3 fix).
    samples = [(0.0, 10.0),        # idle floor
               (1.0, 100_000.0),   # 100 s queued behind real work
               (102.0, 10.0), (103.0, 10.0), (104.0, 10.0)]  # idle tail
    for t, ms in samples:
        rows.append({"t": t, "queue_probe_ms": ms,
                     "0": {"bytes_in_use": 1000, "peak_bytes_in_use": 2000}})
    path = tmp_path / "device_memory.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    out = summarize_monitor_logs(str(tmp_path))
    assert out["peak_device_bytes_in_use"] == 2000
    assert out["queue_probe_idle_floor_ms"] == 10.0
    # busy_ms = 100000 - 10 over elapsed = 104 s + 10 ms last probe
    expected = (100_000.0 - 10.0) / (104_000.0 + 10.0)
    assert abs(out["device_busy_fraction_est"] - expected) < 1e-3
    assert out["device_busy_fraction_est"] > 0.9   # NOT the 0.2 of counting
    assert out["queue_probe_median_ms"] == 10.0


def test_utilization_estimators_reconciliation(tmp_path):
    """The two utilization numbers answer different questions and must
    diverge exactly as documented (bench_tracker.UTILIZATION_METHODOLOGY):
    a host-bound run with per-drain wire RTT shows stall >> occupancy; a
    device-bound overlapped run shows occupancy >> stall."""
    import json
    import time as _t

    from mini_parallel.utils import bench_tracker as bt
    from mini_parallel.utils.perf_logger import summarize_monitor_logs

    # --- scenario A: host-bound. Drains block 2 s of a 10 s run (wire
    # RTT), but the device queue is idle at every probe.
    run = tmp_path / "runA"
    run.mkdir()
    rows = []
    t = 1000.0
    for _ in range(10):
        rows.append({"t": t, "queue_probe_ms": 10.0})   # idle floor
        t += 1.0
    with open(run / "device_memory.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    occ = summarize_monitor_logs(str(run))["device_busy_fraction_est"]
    assert occ == 0.0  # no probe ever waited: device queue idle

    tr = bt.BenchmarkTracker(workload="t", chunk_size_reads=1, device="d",
                             mode="kadane", results_dir=str(tmp_path))
    tr._t0 = _t.perf_counter() - 10.0  # pretend 10 s elapsed
    tr.add_device_seconds(2.0)
    r = tr.finish()
    assert abs(r.device_duty_cycle - 0.2) < 0.01  # stall = 20% >> occ = 0
    assert r.host_info["utilization_methodology"] \
        == bt.UTILIZATION_METHODOLOGY

    # --- scenario B: device-bound, fully overlapped. Zero drain-blocked
    # wall, but probes spend most of the elapsed time queued.
    run = tmp_path / "runB"
    run.mkdir()
    rows = [{"t": 2000.0, "queue_probe_ms": 10.0},
            {"t": 2001.0, "queue_probe_ms": 4000.0},  # 4 s stuck in queue
            {"t": 2005.0, "queue_probe_ms": 10.0}]
    with open(run / "device_memory.jsonl", "w") as f:
        for r2 in rows:
            f.write(json.dumps(r2) + "\n")
    out = summarize_monitor_logs(str(run))
    assert out["device_busy_fraction_est"] > 0.75  # ~3.99/5.01
    tr = bt.BenchmarkTracker(workload="t", chunk_size_reads=1, device="d",
                             mode="kadane", results_dir=str(tmp_path))
    tr._t0 = _t.perf_counter() - 5.0
    r = tr.finish()
    assert r.device_duty_cycle is None  # no drain-blocked wall recorded
