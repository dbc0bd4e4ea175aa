"""Headline benchmark: batched Smith-Waterman on one GPU.

Scores BASELINE.json config 2 — "Batched SW: 10k reads x 150bp" — through
the engine's scorer (ops/sw_gpu.py:sw_score_batch_best) and prints ONE JSON
line:

    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

value: DP throughput in GCUPS (giga cell-updates/sec) for true
Smith-Waterman over the 10,000-pair batch (10k x 150 x 150 = 225e6 cells),
from the median of timed calls that each end in ``block_until_ready``.

vs_baseline: the reference never published throughput (SURVEY.md §6); its
only stated performance target is "sub-200 ms processing" per chunk
(improvements.txt:61), which it did not achieve. vs_baseline is therefore
(200 ms / measured batch latency) on the same 10k-read unit of work — >1.0
means faster than the reference's aspirational target.

It refuses to run without a GPU: a CPU time is not a device number.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

READS = 10_000
READ_LEN = 150
PAD = 152  # 150bp padded to a multiple of 4 (the kernel's subject words)
REFERENCE_TARGET_MS = 200.0  # improvements.txt:61 (aspirational, not achieved)
REPEATS = 20


def main() -> int:
    import jax
    import jax.numpy as jnp

    from mini_parallel.device import enable_compile_cache
    from mini_parallel.ops import encode
    from mini_parallel.ops.sw_gpu import sw_score_batch_best

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU (found {dev.platform})", file=sys.stderr)
        return 1
    enable_compile_cache()

    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    arr_a = np.full((READS, PAD), encode.PAD_A, np.uint8)
    arr_b = np.full((READS, PAD), encode.PAD_B, np.uint8)
    arr_a[:, :READ_LEN] = rng.choice(base, size=(READS, READ_LEN))
    arr_b[:, :READ_LEN] = rng.choice(base, size=(READS, READ_LEN))
    a = jnp.asarray(arr_a)
    b = jnp.asarray(arr_b)

    sw_score_batch_best(a, b).block_until_ready()  # compile
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        sw_score_batch_best(a, b).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    cells = READS * READ_LEN * READ_LEN
    print(json.dumps({
        "metric": "batched_sw_10k_reads_150bp",
        "value": cells / dt / 1e9,
        "unit": "GCUPS",
        "vs_baseline": REFERENCE_TARGET_MS / (dt * 1e3),
        "extra": {
            "batch_latency_ms": dt * 1e3,
            "reads_per_s": READS / dt,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
