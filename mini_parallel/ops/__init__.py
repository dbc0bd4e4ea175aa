"""Compute ops: encoders, alignment scorers, k-mer kernels.

Pure-JAX implementations run on every platform; the one hand-written
kernel (the batched SW scorer, ``sw_gpu.py`` with ``native/sw_score.cu``)
runs on the GPU and is validated against the pure-JAX/NumPy goldens in
``tests/`` and ``tools/kernel_check.py``.
"""
