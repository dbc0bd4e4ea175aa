"""Multi-host WGS processing: file sharding + cross-process result merge.

The reference is strictly single-process/single-GPU; this module is the
pod-slice scaling path from BASELINE.json ("8 lanes x 2 reads of 50GB WGS
sharded across N>=2 hosts with merged scores/histograms", config 5):

- **file -> host assignment** is a static round-robin interleave: lane files
  have skewed sizes, and interleaving (rather than block-splitting) keeps
  per-host byte totals close (SURVEY.md §7's "hard parts" note).
- each process runs the standard orchestrator on its shard, with
  process-scoped checkpoint run IDs (independent resume per host),
- totals merge with ``multihost_utils.process_allgather`` — a single tiny
  all-gather over DCN at the end of the run; per-chunk work never crosses
  hosts, which is what makes >=80% linear reads/s scaling attainable.

Single-process degenerates to the local path, so all logic is testable
without a pod (plus simulated assignment tests in tests/test_distributed.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mini_parallel.models.alignment import AlignmentEngine, FileResult
from mini_parallel.parallel.mesh import initialize_distributed
from mini_parallel.utils.config import Config


def shard_files(files: list[str], process_id: int, num_processes: int) -> list[str]:
    """Round-robin interleave (stable under skewed lane sizes)."""
    return [f for i, f in enumerate(files) if i % num_processes == process_id]


@dataclass
class WorkPlan:
    """Size-aware file->host plan (SURVEY.md §7 hard parts: skewed lanes).

    ``exclusive[p]``: files process p runs alone. ``shared``: files too
    large for any single host's fair share — every process runs them with
    ``chunk_stride=(p, nproc)`` (each owns every nproc-th chunk; chunk
    scores are independent sums, so stripes merge exactly). Greedy LPT on
    byte sizes bounds the exclusive makespan at 4/3 of optimal; sharing
    the oversized files bounds the total makespan at ~ideal + one chunk.
    """

    exclusive: list[list[str]]
    shared: list[str]

    def makespan_bytes(self, sizes: dict[str, int]) -> int:
        per_shared = sum(sizes.get(f, 0) for f in self.shared) // max(
            len(self.exclusive), 1
        )
        return per_shared + max(
            (sum(sizes.get(f, 0) for f in shard) for shard in self.exclusive),
            default=0,
        )


def plan_work(
    files: list[str],
    num_processes: int,
    sizes: dict[str, int] | None = None,
) -> WorkPlan:
    """Deterministic size-aware plan, identical on every process.

    Files bigger than the ideal per-host share are chunk-strided across all
    processes; the rest are greedy-LPT assigned (largest first onto the
    least-loaded host). Replaces blind round-robin, whose makespan on a
    10:1 skewed lane set is ~2x the even split. Unknown sizes (stat
    failure) fall back to size 1, degrading to cardinality balancing.

    Callers in a multi-process run must pass sizes agreed across hosts
    (process_full_wgs_distributed broadcasts process 0's stats): per-host
    stat results can diverge (transient NFS errors) and a divergent plan
    silently double-processes or drops files globally.

    Known limit of chunk-striding: every process still DECODES the whole
    shared file and keeps only its stripe, so the win applies when device
    compute dominates decode (native decode 0.78M reads/s vs 200-350k
    reads/s engine throughput — the common case). Decode-bound sharing
    would need byte-range splits with FASTQ record resync.
    """
    if num_processes <= 1:
        return WorkPlan(exclusive=[list(files)], shared=[])
    if sizes is None:
        import os

        sizes = {}
        for f in files:
            try:
                sizes[f] = os.path.getsize(f)
            except OSError:
                sizes[f] = 1
    total = sum(max(sizes.get(f, 1), 1) for f in files)
    ideal = total / num_processes
    shared = [f for f in files if max(sizes.get(f, 1), 1) > ideal]
    rest = [f for f in files if f not in shared]
    loads = [0] * num_processes
    exclusive: list[list[str]] = [[] for _ in range(num_processes)]
    # LPT: stable tie-break on the original index keeps the plan identical
    # across processes
    order = sorted(range(len(rest)),
                   key=lambda i: (-max(sizes.get(rest[i], 1), 1), i))
    for i in order:
        p = min(range(num_processes), key=lambda q: (loads[q], q))
        exclusive[p].append(rest[i])
        loads[p] += max(sizes.get(rest[i], 1), 1)
    # keep each shard in original file order (checkpoint indices stay stable)
    pos = {f: i for i, f in enumerate(files)}
    for shard in exclusive:
        shard.sort(key=pos.__getitem__)
    return WorkPlan(exclusive=exclusive, shared=shared)


@dataclass
class DistributedTotals:
    files: int
    reads: int
    bases: int
    score: int
    seconds_max: float  # wall time = slowest host


def merge_totals(local: DistributedTotals) -> DistributedTotals:
    """All-gather per-host totals and reduce. Identity when single-process."""
    import jax

    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils

    vec = np.array(
        [local.files, local.reads, local.bases, local.score], dtype=np.int64
    )
    gathered = multihost_utils.process_allgather(vec)  # (n_proc, 4)
    secs = multihost_utils.process_allgather(
        np.array([local.seconds_max], dtype=np.float64)
    )
    f, r, b, s = gathered.sum(axis=0).tolist()
    return DistributedTotals(
        files=int(f), reads=int(r), bases=int(b), score=int(s),
        seconds_max=float(secs.max()),
    )


def _agreed_sizes(files: list[str], nproc: int) -> dict[str, int]:
    """File sizes every process AGREES on: process 0 stats, others adopt.

    A per-host stat divergence (transient I/O error) would otherwise yield
    divergent plans that double-process or drop files globally."""
    import os

    import jax

    local = np.array(
        [max(_stat_size(f), 1) for f in files], dtype=np.int64
    )
    if nproc > 1 and jax.process_count() > 1:
        from jax.experimental import multihost_utils

        gathered = multihost_utils.process_allgather(local)  # (nproc, n)
        local = gathered[0]
    return dict(zip(files, (int(x) for x in local)))


def _stat_size(path: str) -> int:
    import os

    try:
        return os.path.getsize(path)
    except OSError:
        return 1


def _stripe_with_retries(engine, path, pid, nproc, retries, echo,
                         state=None, file_index=0):
    """Run this process's chunk stripe of a shared file, resuming from the
    last chunk checkpoint on failure (retries times).

    When ``state`` (a CheckpointState) is given, stripe progress persists
    to disk like exclusive files do — a HOST CRASH mid- or post-stripe
    resumes from the last owned-chunk checkpoint instead of re-processing
    the whole stripe (advisor round-2 finding). chunks_done is counted in
    OWNED-chunk index space, matching self_align_file's chunk_stride
    resume semantics."""
    from mini_parallel.models.alignment import FileResult
    from mini_parallel.utils.checkpoint import FileCheckpoint

    prior = state.get_file(file_index) if state is not None else None
    if prior is not None and prior.chunks_done == 0:
        prior = None
    partial: list = [prior]

    def on_checkpoint(res: FileResult):
        if state is not None:
            state.add_file_result(FileCheckpoint(
                file_path=path, file_index=file_index, score=res.score,
                processing_time_ms=res.seconds * 1000.0,
                total_bases=res.total_bases, total_reads=res.total_reads,
                completed=False, chunks_done=res.chunks,
            ))
            partial[0] = state.get_file(file_index)
        else:
            import copy

            snap = copy.copy(res)
            snap.chunks_done = res.chunks  # owned-chunk index space
            snap.processing_time_ms = res.seconds * 1000.0
            partial[0] = snap

    attempt = 0
    while True:
        try:
            return engine.self_align_file(
                path, progress=echo, chunk_stride=(pid, nproc),
                resume=partial[0], checkpoint_every=50,
                on_checkpoint=on_checkpoint,
            )
        except Exception as e:
            attempt += 1
            if attempt > retries:
                raise RuntimeError(
                    f"shared file {path} stripe {pid}/{nproc} failed: {e}"
                ) from e
            done = getattr(partial[0], "chunks_done", 0) if partial[0] else 0
            echo(f"  shared-file stripe attempt {attempt} failed ({e}); "
                 f"retrying from owned chunk {done}")


def process_full_wgs_distributed(
    engine: AlignmentEngine,
    cfg: Config | None = None,
    checkpoint_dir: str = ".",
    echo=print,
    retries: int = 0,
) -> tuple[list[FileResult], DistributedTotals]:
    """Run --full-wgs across all JAX processes; returns (local results,
    globally merged totals)."""
    import jax

    from mini_parallel.models.wgs import process_full_wgs_dataset

    initialize_distributed()  # idempotent; the CLI already ran it at startup
    pid, nproc = jax.process_index(), jax.process_count()
    files = cfg.wgs_file_list() if cfg else engine.cfg.wgs_file_list()
    plan = plan_work(files, nproc, sizes=_agreed_sizes(files, nproc))
    my_files = plan.exclusive[pid] if pid < len(plan.exclusive) else []
    echo(f"[host {pid}/{nproc}] processing {len(my_files)}/{len(files)} "
         f"files exclusively"
         + (f" + {len(plan.shared)} shared (chunk-strided)"
            if plan.shared else ""))

    results = process_full_wgs_dataset(
        engine,
        cfg,
        checkpoint_dir=checkpoint_dir,
        echo=echo,
        files=my_files,
        retries=retries,
    )
    # oversized files: every process runs its chunk stripe, with the same
    # elastic-retry AND persistent-checkpoint semantics as exclusive files.
    # Stripe state is keyed per (shared set, pid, nproc) so a host crash —
    # even after a stripe completed — resumes/skips instead of re-running.
    # Known gap (documented): stripe drain_seconds land on the returned
    # FileResults but not on the exclusive-files BenchmarkTracker, which
    # process_full_wgs_dataset already finished; duty-cycle aggregation
    # over shared files is the caller's to fold from the results list.
    stripe_state = None
    if plan.shared:
        from mini_parallel.utils.checkpoint import (
            CheckpointState,
            FileCheckpoint,
            deterministic_run_id,
        )

        c = cfg or engine.cfg
        sid = deterministic_run_id(
            c.sample_id, list(plan.shared), engine.mode,
            chunk_size=c.chunk_size_reads,
        ) + f"_stripe{pid}of{nproc}"
        stripe_state = CheckpointState.load(sid, checkpoint_dir)
        if stripe_state is None:
            stripe_state = CheckpointState(
                run_id=sid, total_files=len(plan.shared),
                directory=checkpoint_dir,
            )
    for si, path in enumerate(plan.shared):
        if stripe_state.is_file_completed(si):
            prev = stripe_state.get_file(si)
            echo(f"[host {pid}/{nproc}] shared file {path}: stripe already "
                 f"completed, skipping")
            results.append(FileResult(
                file_path=prev.file_path, score=prev.score,
                total_bases=prev.total_bases, total_reads=prev.total_reads,
                chunks=prev.chunks_done,
                seconds=prev.processing_time_ms / 1000.0,
            ))
            continue
        echo(f"[host {pid}/{nproc}] shared file {path}: "
             f"chunks {pid}::{nproc}")
        res = _stripe_with_retries(engine, path, pid, nproc, retries, echo,
                                   state=stripe_state, file_index=si)
        stripe_state.add_file_result(FileCheckpoint(
            file_path=path, file_index=si, score=res.score,
            processing_time_ms=res.seconds * 1000.0,
            total_bases=res.total_bases, total_reads=res.total_reads,
            completed=True, chunks_done=res.chunks,
        ))
        results.append(res)
    # stripe partials sum exactly across processes for reads/bases/score,
    # but each shared FILE must count once globally -> attribute to pid 0
    n_files = len(my_files) + (len(plan.shared) if pid == 0 else 0)
    local = DistributedTotals(
        files=n_files,
        reads=sum(r.total_reads for r in results),
        bases=sum(r.total_bases for r in results),
        score=sum(r.score for r in results),
        seconds_max=sum(r.seconds for r in results),
    )
    merged = merge_totals(local)
    if pid == 0 and nproc > 1:
        echo(
            f"[global] files={merged.files} reads={merged.reads} "
            f"bases={merged.bases} score={merged.score}"
        )
    return results, merged
