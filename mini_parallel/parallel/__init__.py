"""Multi-chip / multi-host scaling: meshes, shardings, collective merges.

The reference has no distribution at all (single GPU, devices[0] only —
`smith_waterman/src/gpu.rs:125`, `main.rs:95`); its only "collective" is a
device-local atomic_max (`smith_waterman.cl:69`) and host-side score addition
(`aligner.rs:276`). This package is the from-scratch replacement: FASTQ read
batches are sharded over a ``data`` mesh axis, long sequences over a ``seq``
axis, and per-shard scores/histograms merge with psum/pmax — collectives
that XLA hands to NCCL across the cards of a host.
"""
