"""Device mesh construction and multi-host bring-up."""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"  # read-batch (data-parallel) axis
SEQ_AXIS = "seq"  # sequence-position (sequence-parallel) axis


_distributed_initialized = False


def initialize_distributed() -> bool:
    """Multi-host bring-up via jax.distributed, driven by env vars.

    MUST run before anything touches a JAX backend (jax.devices(), any
    computation) — jax.distributed.initialize refuses afterwards. The CLI
    calls this first thing in main(); library users on a pod slice should
    call it at startup. Idempotent. Controlled by standard JAX envs
    (JAX_COORDINATOR_ADDRESS required; JAX_NUM_PROCESSES / JAX_PROCESS_ID
    optional — JAX auto-detects when unset). Returns True when running in
    distributed mode.
    """
    global _distributed_initialized
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coord:
        return False
    if _distributed_initialized:
        return True
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    try:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc) if nproc else None,
            process_id=int(pid) if pid else None,
        )
    except RuntimeError as e:
        msg = str(e)
        if ("must be called before" in msg or "backend" in msg
                or "only be called once" in msg):
            # a backend came up before us: distributed mode is impossible now
            raise RuntimeError(
                "jax.distributed must initialize before any JAX backend use; "
                "call mini_parallel.parallel.mesh.initialize_distributed()"
                " at process startup (the CLI does this automatically)"
            ) from e
        raise
    _distributed_initialized = True
    return True


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] | None = None,
              devices: list | None = None) -> Mesh:
    """Build a mesh over all devices.

    shape=None: all devices on the data axis — the right default for this
    workload, where reads are embarrassingly parallel and collectives only
    merge scalars/histograms.
    shape=(d, s): 2-D (data, seq) mesh; the seq axis serves sequence-parallel
    scoring of very long sequences (halo-free Kadane monoid merges).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if shape is None or shape == ():
        shape = (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    if axis_names is None:
        axis_names = (DATA_AXIS, SEQ_AXIS)[: len(shape)]
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def pad_to_shards(n: int, num_shards: int, multiple: int = 1) -> int:
    """Round n up so it divides evenly into num_shards * multiple."""
    q = num_shards * multiple
    return -(-n // q) * q
