"""Batched linear-gap Smith-Waterman on NVIDIA Hopper.

The hot-path scorer (the ``bench.py`` headline, self-align sw,
complementarity and the sharded WGS step all call
:func:`sw_score_batch_best`). On a GPU it runs the CUDA kernel in
``native/sw_score.cu`` through the XLA foreign function interface; the
kernel packs two pairs into the 16-bit halves of each register and updates
two cells per Hopper DPX instruction (see the kernel's header comment).
Elsewhere, and for shapes whose scores could overflow 16 bits, it runs the
plain ``lax.scan`` of ``ops/sw.py`` — the same semantics, and the oracle the
kernel is checked against.

The library is compiled from the repository's source with ``nvcc`` on
first use (``sm_90a``, where the DPX instructions exist) into
``native/libswscore.so``, which ``.gitignore`` lists. A GPU platform without
``nvcc`` is an error, never a quiet fall back to the scan.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from mini_parallel.ops.encode import PAD_A, PAD_B
from mini_parallel.ops.sw import (GAP_PENALTY, MATCH_SCORE,
                                      MISMATCH_PENALTY, sw_score_batch)

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
SOURCE = os.path.join(_NATIVE, "sw_score.cu")
LIBRARY = os.path.join(_NATIVE, "libswscore.so")
TARGET = "mpt_sw_score"

# (threads per pair group, query rows per thread) variants compiled into
# the library (native/sw_score.cu:pick lists the same set), in order of
# chunk height G*R. Timed against each other at 10k pairs on an H100
# (PERF.md), each is the fastest at the query height it serves: 160 rows
# (150 bp reads), 256, 512, and 1024 rows per pass above that.
CONFIGS = ((16, 10), (32, 8), (32, 16), (32, 32))
_INT16_MAX = (1 << 15) - 1


def kernel_fits(M: int, N: int) -> bool:
    """True when every DP value fits the kernel's signed 16-bit lanes."""
    return MATCH_SCORE * min(M, N) <= _INT16_MAX and M > 0 and N > 0


def route(platform: str, M: int, N: int) -> str:
    """Which implementation scores a (B, M) x (B, N) batch: ``"cuda"`` on a
    GPU when the scores fit 16 bits, ``"scan"`` otherwise."""
    return "cuda" if platform == "gpu" and kernel_fits(M, N) else "scan"


def pick_config(M: int) -> tuple[int, int]:
    """The (group, rows) variant with the shortest chunk that holds M query
    rows in one pass; taller queries run the tallest chunk in passes."""
    for group, rows in CONFIGS:
        if group * rows >= M:
            return group, rows
    return CONFIGS[-1]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "the GPU Smith-Waterman kernel needs nvcc (CUDA toolkit) to build "
        f"{LIBRARY} from {SOURCE}")


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.MptSwScore),
                                platform="CUDA")


def sw_score_batch_cuda(seq_a: jnp.ndarray,
                        seq_b: jnp.ndarray) -> jnp.ndarray:
    """Batched SW scores via the CUDA kernel (GPU only).

    Args match ops/sw.py:sw_score_batch: (B, M) uint8 padded with PAD_A and
    (B, N) uint8 padded with PAD_B. Returns (B,) int32.
    """
    M, N = seq_a.shape[1], seq_b.shape[1]
    if not kernel_fits(M, N):
        raise ValueError(f"sw_score_batch_cuda: scores of {M} x {N} pairs "
                         "can overflow 16 bits; use ops.sw.sw_score_batch")
    return _cuda_scores(seq_a, seq_b, pick_config(M))


@functools.partial(jax.jit, static_argnames=("config",))
def _cuda_scores(seq_a, seq_b, config: tuple[int, int]):
    group, rows = config
    B, M = seq_a.shape
    N = seq_b.shape[1]
    _register()
    Np = -(-N // 4) * 4  # the kernel reads subject rows as 32-bit words
    b = seq_b.astype(jnp.uint8)
    if Np != N:
        b = jnp.pad(b, ((0, 0), (0, Np - N)), constant_values=int(PAD_B))
    passes = -(-M // (group * rows))
    top = (-(-B // 2) * Np,) if passes > 1 else (1,)
    out, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((B,), jnp.int32),
         jax.ShapeDtypeStruct(top, jnp.uint32)),
    )(seq_a.astype(jnp.uint8), b,
      group=np.int64(group), rows=np.int64(rows),
      match=np.int64(MATCH_SCORE), mismatch=np.int64(MISMATCH_PENALTY),
      gap=np.int64(GAP_PENALTY), pad_a=np.int64(PAD_A),
      pad_b=np.int64(PAD_B))
    return out


def sw_score_batch_best(seq_a: jnp.ndarray,
                        seq_b: jnp.ndarray) -> jnp.ndarray:
    """SW scores by the implementation :func:`route` picks for this
    platform and shape."""
    M, N = seq_a.shape[1], seq_b.shape[1]
    if route(jax.default_backend(), M, N) == "cuda":
        return sw_score_batch_cuda(seq_a, seq_b)
    return sw_score_batch(seq_a, seq_b)
