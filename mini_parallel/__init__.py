"""mini_parallel: a sequence-analysis framework on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of
bmwoolf/mini_parallel (Rust + OpenCL, single GPU): Smith-Waterman local
alignment, k-mer counting, and variant-call prep over whole-genome-sequencing
FASTQ data:

- alignment DP as anti-diagonal scans batched across pairs, with a CUDA
  kernel for the hot batched scorer (``ops/``, ``native/sw_score.cu``),
- FASTQ lanes streamed data-parallel over a ``jax.sharding.Mesh`` with
  psum/pmax merges (``parallel/``),
- a native C++ host data plane for FASTQ decode and k-mer aggregation
  (``native/``),
- the reference's CLI modes, .env config, checkpoint/resume, and JSON
  benchmark outputs (``cli.py``, ``utils/``).

Reference behaviors are cited as ``file:line`` into /root/reference
throughout so parity can be audited.
"""

__version__ = "0.1.0"

from mini_parallel.ops import encode, kadane, sw  # noqa: F401
