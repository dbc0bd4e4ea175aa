"""System/device introspection.

Mirrors the reference's ``SystemInfo`` intent
(`smith_waterman/src/system_info.rs:16-45`): device name/memory for banners,
memory budgeting, and benchmark metadata — but sourced from the JAX runtime
(device kind, memory stats via ``device.memory_stats()``) instead of the
reference's nvidia-smi/lspci/VRAM-table waterfall (system_info.rs:48-194).
Host RAM still comes from /proc/meminfo (system_info.rs:197-233).

Like the reference, results are computed once and cached
(system_info.rs:270-275).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

HBM_BUDGET_FRACTION = 0.8  # 80%-of-memory budget, system_info.rs:236-238


@dataclass
class SystemInfo:
    device_kind: str = "unknown"
    device_count: int = 0
    platform: str = "none"
    hbm_bytes_limit: int | None = None
    hbm_bytes_in_use: int | None = None
    cpu_cores: int = 0
    total_ram_gb: float = 0.0
    hostname: str = ""
    extra: dict = field(default_factory=dict)

    def available_device_memory_bytes(self) -> int | None:
        """80% of HBM, the reference's budget rule (system_info.rs:236-243)."""
        if self.hbm_bytes_limit is None:
            return None
        return int(self.hbm_bytes_limit * HBM_BUDGET_FRACTION)

    def banner(self) -> str:
        hbm = (
            f"{self.hbm_bytes_limit / 2**30:.1f} GB HBM"
            if self.hbm_bytes_limit
            else "HBM unknown"
        )
        return (
            f"Device: {self.device_kind} x{self.device_count} ({self.platform}, {hbm}) | "
            f"Host: {self.cpu_cores} cores, {self.total_ram_gb:.0f} GB RAM"
        )


def _host_ram_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0


@functools.lru_cache(maxsize=1)
def get_system_info() -> SystemInfo:
    import socket

    info = SystemInfo(
        cpu_cores=os.cpu_count() or 0,
        total_ram_gb=_host_ram_gb(),
        hostname=socket.gethostname(),
    )
    try:
        import jax

        devs = jax.devices()
        info.device_count = len(devs)
        if devs:
            d = devs[0]
            info.device_kind = d.device_kind
            info.platform = d.platform
            try:
                stats = d.memory_stats() or {}
                info.hbm_bytes_limit = stats.get("bytes_limit")
                info.hbm_bytes_in_use = stats.get("bytes_in_use")
            except Exception:  # memory_stats unsupported on some backends
                pass
    except Exception as e:  # JAX init failure: report, don't crash banners
        info.extra["jax_error"] = str(e)
    return info
