"""Accelerator backend management — the gpu.rs analogue.

The reference's L3 layer (`smith_waterman/src/gpu.rs`) owns device discovery
(`is_gpu_available` gpu.rs:33, `get_gpu_devices` gpu.rs:48), a process-wide
context singleton (gpu.rs:97-109), and tuning constants (gpu.rs:9-10). The
JAX equivalents:

- discovery: the JAX runtime enumerates devices; we expose the same probe
  shapes (:func:`is_accelerator_available`, :func:`get_devices`),
- "context singleton": JAX backends are already process-wide singletons, and
  the compiled-program reuse the reference lacked (it rebuilt its OpenCL
  program every chunk, aligner.rs:504-508) is handled by jit caching plus the
  persistent compilation cache (:func:`enable_compile_cache`),
- tuning constants: the parity-mode dispatch constants live in ops/kadane.py
  (WORK_GROUP_SIZE, MAX_WORK_GROUPS — semantic constants, not launch
  parameters, since XLA owns scheduling).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class DeviceInfo:
    """Mirror of GpuDevice (gpu.rs:18-22): name, memory, max work size."""

    name: str
    platform: str
    index: int
    memory_gb: float | None = None
    extra: dict = field(default_factory=dict)


def is_accelerator_available() -> bool:
    """GPU probe (is_gpu_available, gpu.rs:33)."""
    try:
        import jax

        return any(d.platform == "gpu" for d in jax.devices())
    except Exception:
        return False


def get_devices() -> list[DeviceInfo]:
    """Enumerate accelerator devices (get_gpu_devices, gpu.rs:48)."""
    import jax

    out = []
    for i, d in enumerate(jax.devices()):
        mem = None
        try:
            stats = d.memory_stats() or {}
            if stats.get("bytes_limit"):
                mem = stats["bytes_limit"] / 2**30
        except Exception:
            pass
        out.append(
            DeviceInfo(name=d.device_kind, platform=d.platform, index=i,
                       memory_gb=mem)
        )
    return out


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    it is set, else ``.jax_cache`` at the root of the checkout (a fixed
    path, since the path is part of the cache key)."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compile cache at :func:`compile_cache_dir`
    and keep every compiled program there. Returns the directory, or None
    when it cannot be created."""
    import jax

    cache_dir = compile_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except (OSError, ValueError):
        return None
    return cache_dir
