"""Scaling benchmark: reads/s at increasing mesh sizes.

BASELINE.json measures at "1 chip, 1 host, N>=2 hosts" with a >=80% linear
scaling target. This harness measures the sharded WGS step at every mesh
size available and reports per-size throughput + scaling efficiency.

On a virtual CPU mesh the numbers are functional, NOT performance-
representative — labeled as such in the output. On GPUs, run as-is: it
uses whatever jax.devices() provides per process, and on multiple hosts
each process reports its local shard throughput.

Besides per-size wall clocks this emits *evidence rows*: every mesh size's
stats dict is compared field-by-field against the 1-device run of the same
batch (sharded == local bit-exactness), and the long-pair halo pipeline's
structural constants (stages, bytes/stage, utilization per chip count) are
reported so the comm/compute ratio is checkable at any geometry. With
--out the full row set is written as JSON (benchmark_results/scaling_*.json)
for the record, not just printed.

Usage: python bench_scaling.py [--reads 100000] [--cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--len", type=int, default=150, dest="read_len")
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-device virtual CPU mesh")
    ap.add_argument("--out", default=None,
                    help="also write the full row set to this JSON file")
    args = ap.parse_args()
    out_docs = []

    def emit(doc):
        out_docs.append(doc)
        print(json.dumps(doc))

    import os

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mini_parallel.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from mini_parallel.ops import encode
    from mini_parallel.parallel import mesh as mesh_mod
    from mini_parallel.parallel import pipeline

    n_dev = jax.device_count()
    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    pad = -(-args.read_len // 8) * 8
    arr_a = np.full((args.reads, pad), encode.PAD_A, np.uint8)
    arr_b = np.full((args.reads, pad), encode.PAD_B, np.uint8)
    arr_a[:, : args.read_len] = rng.choice(base, size=(args.reads, args.read_len))
    arr_b[:, : args.read_len] = rng.choice(base, size=(args.reads, args.read_len))
    lens = np.full(args.reads, args.read_len, np.int32)

    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    # Bit-exactness reference: the 1-device run over the largest batch that
    # every mesh size can shard evenly (so all sizes see identical data).
    B_common = (args.reads // max(sizes)) * max(sizes)
    local_stats = None
    rows = []
    for size in sizes:
        mesh = mesh_mod.make_mesh((size,), ("data",),
                                  devices=jax.devices()[:size])
        step = pipeline.make_wgs_step(mesh)
        a, b, la, lb = pipeline.shard_batch(
            mesh,
            (jnp.asarray(arr_a[:B_common]), jnp.asarray(arr_b[:B_common]),
             jnp.asarray(lens[:B_common]), jnp.asarray(lens[:B_common])),
        )
        stats = jax.device_get(step(a, b, la, lb))
        if local_stats is None:
            local_stats = stats
            exact = True
        else:
            exact = all(
                bool(np.array_equal(np.asarray(stats[k]),
                                    np.asarray(local_stats[k])))
                for k in local_stats
            )

        B = B_common

        def timed(iters: int) -> float:
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = step(a, b, la, lb)
            jax.device_get(out)
            return time.perf_counter() - t0

        lo, hi = 1, 5
        dt = max((timed(hi) - timed(lo)) / (hi - lo), 1e-9)
        rows.append({"devices": size, "reads_per_s": B / dt,
                     "batch_ms": dt * 1e3,
                     "stats_bit_exact_vs_local": exact})

    base_rate = rows[0]["reads_per_s"]
    for r in rows:
        r["scaling_efficiency"] = r["reads_per_s"] / (base_rate * r["devices"])
    emit(
        {
            "metric": "wgs_step_scaling",
            "platform": jax.devices()[0].platform,
            "performance_representative": jax.devices()[0].platform == "gpu",
            "reads": B_common,
            "checked_stats": sorted(local_stats),
            "rows": [
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in r.items()}
                for r in rows
            ],
        }
    )

    # Long-pair halo pipeline: the seq-axis engine (ops/sw_long.py
    # sw_score_long_sharded) runs K + C - 1 stages for K b-strips over C
    # chips; a chip is useful in K of them, so pipeline utilization is
    # exactly K/(K+C-1) and the per-stage boundary exchange ships
    # state_arrays x W x 4 bytes between devices (3 arrays linear / 5
    # affine). These are structural constants of the implementation (not
    # wall-clock estimates), reported so scaling reviews can check the
    # comm/compute ratio at any geometry.
    from mini_parallel.ops.sw_long import DEFAULT_WIDTH as W

    for n_len in (500_000, 2_000_000):
        K = -(-n_len // W)
        rows2 = []
        for C in (1, 2, 4, 8):
            rows2.append({
                "chips": C,
                "stages": K + C - 1,
                "pipeline_utilization": round(K / (K + C - 1), 4),
                "halo_bytes_per_stage_linear": 3 * W * 4,
                "halo_bytes_per_stage_affine": 5 * W * 4,
            })
        emit({
            "metric": "long_pair_pipeline_model",
            "b_len": n_len, "strip_w": W, "k_strips": K,
            "rows": rows2,
        })

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out_docs, fh, indent=1)


if __name__ == "__main__":
    main()
