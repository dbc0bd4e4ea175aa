"""Host monitor supervisor: external observers for long runs.

Re-creates the reference's monitor fleet (`smith_waterman/src/perf_logger.rs`):
spawn system monitors writing to ``logs/run_N/`` for the duration of a run
(`perf_logger.rs:74-168`), kill them on stop (`perf_logger.rs:170-206`), and
clean up on Ctrl-C (`perf_logger.rs:271-281`).

Differences: the GPU monitor (``nvidia-smi dmon``) is replaced by a JAX
device-memory sampler thread (no device process to supervise), and
missing monitor binaries are skipped gracefully instead of failing the run.
All monitors are off the critical path (SURVEY.md §7.6).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import threading
import time

MONITOR_CMDS = {
    # name -> argv (perf_logger.rs:95-135 equivalents)
    "iostat": ["iostat", "-dx", "1"],
    "vmstat": ["vmstat", "1"],
    "pidstat": ["pidstat", "-w", "1"],
}


def _next_run_dir(base: str = "logs") -> str:
    os.makedirs(base, exist_ok=True)
    n = 1
    while os.path.exists(os.path.join(base, f"run_{n}")):
        n += 1
    path = os.path.join(base, f"run_{n}")
    os.makedirs(path)
    return path


class SystemMonitors:
    """Spawn/stop external monitors + a device-memory sampler."""

    def __init__(self, log_base: str = "logs", sample_interval_s: float = 1.0):
        self.log_base = log_base
        self.sample_interval_s = sample_interval_s
        self.run_dir: str | None = None
        self._procs: dict[str, subprocess.Popen] = {}
        self._stop_event = threading.Event()
        self._sampler: threading.Thread | None = None

    def start(self) -> str:
        self.run_dir = _next_run_dir(self.log_base)
        cmds = dict(MONITOR_CMDS)
        # perf record -g -p <pid>, the reference's 5th monitor
        # (perf_logger.rs:152-156). SIGTERM on stop() makes perf flush
        # perf.data; absence/unprivileged perf just logs and moves on.
        # MPT_PERF_RECORD=0 disables it (it samples this very process).
        if os.environ.get("MPT_PERF_RECORD", "1") != "0":
            cmds["perf_record"] = [
                "perf", "record", "-g", "-p", str(os.getpid()),
                "-o", os.path.join(self.run_dir, "perf.data"),
            ]
        for name, argv in cmds.items():
            log = open(os.path.join(self.run_dir, f"{name}.log"), "w")
            try:
                self._procs[name] = subprocess.Popen(
                    argv, stdout=log, stderr=subprocess.STDOUT
                )
            except FileNotFoundError:
                log.write(f"{argv[0]} not available on this host\n")
                log.close()
        self._stop_event.clear()
        self._sampler = threading.Thread(target=self._sample_device, daemon=True)
        self._sampler.start()
        return self.run_dir

    def _sample_device(self) -> None:
        """Device-memory + queue-pressure sampler — the nvidia-smi dmon
        analogue (perf_logger.rs:77-82, `dmon -s u` at 1 Hz).

        JAX exposes no utilization counter, so busy-ness is estimated
        from the host: each tick dispatches a tiny
        pre-compiled kernel and times dispatch->fetch. On an idle device
        the probe returns in one link round trip; when real work is queued
        the probe waits behind it, so probe_ms tracks device/queue
        occupancy over time (a latency-based utilization signal, not a
        hardware counter — labeled as such in the summary)."""
        assert self.run_dir is not None
        path = os.path.join(self.run_dir, "device_memory.jsonl")
        probe = None
        try:
            import jax
            import jax.numpy as jnp
            import numpy as _np

            devs = jax.devices()
            x = jnp.zeros((8,), jnp.int32)
            _probe_fn = jax.jit(lambda v: v + 1)
            _np.asarray(_probe_fn(x))  # compile outside the sample loop

            def probe():
                t0 = time.perf_counter()
                _np.asarray(_probe_fn(x))
                return (time.perf_counter() - t0) * 1e3
        except Exception:
            devs = []
        with open(path, "w") as f:
            while not self._stop_event.wait(self.sample_interval_s):
                row = {"t": time.time()}
                for d in devs:
                    try:
                        stats = d.memory_stats() or {}
                        row[str(d.id)] = {
                            "bytes_in_use": stats.get("bytes_in_use"),
                            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                        }
                    except Exception:
                        pass
                if probe is not None:
                    try:
                        row["queue_probe_ms"] = round(probe(), 3)
                    except Exception:
                        pass
                f.write(json.dumps(row) + "\n")
                f.flush()

    def stop(self) -> None:
        self._stop_event.set()
        if self._sampler is not None:
            self._sampler.join(timeout=2)
        for name, proc in self._procs.items():
            with contextlib.suppress(ProcessLookupError):
                proc.terminate()
            try:
                proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError):
                    proc.kill()
        self._procs.clear()


@contextlib.contextmanager
def system_monitors(log_base: str = "logs"):
    """Context manager + SIGINT cleanup (perf_logger.rs:271-281)."""
    mon = SystemMonitors(log_base=log_base)
    mon.start()
    prev = signal.getsignal(signal.SIGINT)

    def handler(signum, frame):
        mon.stop()
        if callable(prev):
            prev(signum, frame)
        else:
            raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        prev = None  # non-main thread: no signal hook
    try:
        yield mon
    finally:
        mon.stop()
        if prev is not None:
            with contextlib.suppress(ValueError):
                signal.signal(signal.SIGINT, prev)


def summarize_monitor_logs(run_dir: str) -> dict:
    """Post-run summary parsed from the monitor logs — the analogue of the
    reference's log parsers (benchmark.rs:249-414), with real numbers only
    (fields are absent when a monitor didn't run, never invented)."""
    import os

    out: dict = {}

    def _floats(parts, idx):
        try:
            return float(parts[idx])
        except (ValueError, IndexError):
            return None

    # vmstat: max context switches/s (cs column), min free memory
    path = os.path.join(run_dir, "vmstat.log")
    if os.path.exists(path):
        cs_max, free_min = None, None
        with open(path) as f:
            header_idx = {}
            for line in f:
                parts = line.split()
                if "cs" in parts and "free" in parts:
                    header_idx = {name: i for i, name in enumerate(parts)}
                    continue
                if not header_idx or not parts or not parts[0].isdigit():
                    continue
                cs = _floats(parts, header_idx.get("cs", -1))
                fr = _floats(parts, header_idx.get("free", -1))
                if cs is not None:
                    cs_max = cs if cs_max is None else max(cs_max, cs)
                if fr is not None:
                    free_min = fr if free_min is None else min(free_min, fr)
        if cs_max is not None:
            out["max_context_switches_per_s"] = cs_max
        if free_min is not None:
            out["min_free_memory_kb"] = free_min

    # iostat -dx: peak read throughput (rkB/s column)
    path = os.path.join(run_dir, "iostat.log")
    if os.path.exists(path):
        peak = None
        with open(path) as f:
            col = None
            for line in f:
                parts = line.split()
                if parts and parts[0] == "Device":
                    for i, name in enumerate(parts):
                        if name.startswith("rkB/s") or name == "rkB/s":
                            col = i
                    continue
                if col is None or not parts or parts[0] == "Device":
                    continue
                v = _floats(parts, col)
                if v is not None:
                    peak = v if peak is None else max(peak, v)
        if peak is not None:
            out["peak_disk_read_kb_per_s"] = peak

    # device_memory.jsonl: peak HBM in use
    path = os.path.join(run_dir, "device_memory.jsonl")
    if os.path.exists(path):
        import json as _json

        peak = None
        probes: list[float] = []
        probe_ts: list[float] = []
        with open(path) as f:
            for line in f:
                try:
                    row = _json.loads(line)
                except _json.JSONDecodeError:
                    continue
                p = row.get("queue_probe_ms")
                if isinstance(p, (int, float)):
                    probes.append(float(p))
                    t = row.get("t")
                    probe_ts.append(float(t) if isinstance(t, (int, float))
                                    else 0.0)
                for key, val in row.items():
                    if key == "t" or not isinstance(val, dict):
                        continue
                    v = val.get("peak_bytes_in_use") or val.get("bytes_in_use")
                    if v:
                        peak = v if peak is None else max(peak, v)
        if peak is not None:
            out["peak_device_bytes_in_use"] = int(peak)
        if probes:
            # latency-based utilization, TIME-weighted: the probe BLOCKS the
            # sampling loop while it waits behind queued device work, so a
            # long busy window yields one sample with a huge latency rather
            # than many busy samples. Counting samples would bias the
            # estimate low in exactly the busy regime; instead sum the
            # over-floor probe wait time and divide by elapsed wall time.
            floor = min(probes)
            busy_ms = sum(p - floor for p in probes if p > 3 * floor)
            # row timestamps are taken BEFORE each probe, so elapsed wall
            # spans first-row t .. last-row t + last probe's own wait.
            elapsed_ms = (probe_ts[-1] - probe_ts[0]) * 1e3 + probes[-1]
            out["queue_probe_idle_floor_ms"] = round(floor, 3)
            out["queue_probe_median_ms"] = round(
                sorted(probes)[len(probes) // 2], 3)
            if elapsed_ms > 0:
                out["device_busy_fraction_est"] = round(
                    min(1.0, busy_ms / elapsed_ms), 4)

    return out
