"""CLI: the reference's four modes on the GPU engine.

Flag surface mirrors ``smith_waterman/src/main.rs:11-46``:
  --seq1/-1, --seq2/-2   direct two-string alignment (main.rs:183-191)
  --files/-f             pair-file alignment mode (main.rs:170-182)
  --chunk-size/-c        chunk size override (declared-but-unused in the
                         reference, main.rs:27-31; functional here: overrides
                         GPU_CHUNK_SIZE_READS)
  --gpu/-g               accepted for compatibility; the accelerator is
                         always used when present (the reference made the GPU
                         mandatory and exited without one, main.rs:76-79 —
                         we do the same unless --allow-cpu)
  --num-files/-n         accepted for compatibility (unused in the reference,
                         main.rs:33-37)
  --test-wgs/-t          smoke mode: base-count the first lane pair
                         (main.rs:127-153)
  --full-wgs             full dataset with checkpoint/resume (main.rs:72-124)
Plus additions: --mode {kadane,sw,sw-affine,contiguous}, --allow-cpu, --env.
"""

from __future__ import annotations

import argparse
import os
import time
import sys

from mini_parallel.utils import config as config_mod
from mini_parallel.utils.system_info import get_system_info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mini_parallel",
        description="GPU sequence analysis: Smith-Waterman alignment, "
        "k-mer counting, variant-call prep.",
    )
    p.add_argument("-1", "--seq1", help="first sequence (or file path with --files)")
    p.add_argument("-2", "--seq2", help="second sequence (or file path with --files)")
    p.add_argument("-f", "--files", action="store_true",
                   help="treat --seq1/--seq2 as FASTQ file paths")
    p.add_argument("-c", "--chunk-size", type=int, default=None,
                   help="reads per chunk (overrides GPU_CHUNK_SIZE_READS)")
    p.add_argument("-g", "--gpu", action="store_true",
                   help="compatibility flag; accelerator is used when present")
    p.add_argument("-n", "--num-files", type=int, default=None,
                   help="compatibility flag (unused, matches reference)")
    p.add_argument("-t", "--test-wgs", action="store_true",
                   help="smoke-test WGS file reading (first lane pair)")
    p.add_argument("--full-wgs", action="store_true",
                   help="process the full WGS dataset with checkpoint/resume")
    p.add_argument("--mode", choices=("kadane", "sw", "sw-affine", "contiguous"), default=None,
                   help="scoring mode: kadane=reference parity (default), "
                   "sw=true Smith-Waterman, sw-affine=affine gaps (Gotoh), "
                   "contiguous=exact contiguous Kadane")
    p.add_argument("--kmer", metavar="FASTQ[,FASTQ...]",
                   help="count k-mers in FASTQ(.gz) file(s); comma-separate "
                   "lanes to count a whole sample (k_mer workload)")
    p.add_argument("-k", "--kmer-size", type=int, default=21,
                   help="k for --kmer (default 21)")
    p.add_argument("--canonical", action="store_true",
                   help="fold k-mers with their reverse complements")
    p.add_argument("--kmer-out", metavar="PATH", default=None,
                   help="write all distinct k-mer counts as '<kmer>\\t<count>' "
                   "lines (gzip when PATH ends in .gz)")
    p.add_argument("--kmer-checkpoint", metavar="NPZ", default=None,
                   help="crash-resumable --kmer runs: snapshot merged counts "
                   "to this .npz and resume from it if it exists")
    p.add_argument("--kmer-checkpoint-every", type=int, default=200,
                   metavar="N", help="chunks between --kmer-checkpoint "
                   "snapshots (default 200)")
    p.add_argument("--complementarity", action="store_true",
                   help="direct+complementary mate-pair analysis of -1/-2 "
                   "lane files (%% non-complementary metric)")
    p.add_argument("--variant-prep", metavar="FASTQ[,FASTQ...]",
                   help="map reads to --reference, build pileup, emit "
                   "candidate variant sites; comma-separate lanes to process "
                   "a whole sample (variant_calling workload)")
    p.add_argument("--reference", metavar="FASTA",
                   help="reference FASTA(.gz) for --variant-prep")
    p.add_argument("--vcf-out", metavar="PATH", default=None,
                   help="write candidate sites as VCF (with --variant-prep)")
    p.add_argument("--sam-out", metavar="PATH", default=None,
                   help="write traceback alignments as SAM (with "
                   "--variant-prep)")
    p.add_argument("--gapped", action="store_true",
                   help="CIGAR-based gapped pileup for --variant-prep "
                   "(indel-tolerant; slower)")
    p.add_argument("--gap-model", choices=("linear", "affine"),
                   default="linear",
                   help="gap scoring for --gapped traceback (affine = Gotoh "
                   "with MPT_GAP_OPEN/MPT_GAP_EXTEND)")
    p.add_argument("--min-base-quality", type=int, default=0,
                   help="exclude bases below this Phred score from the "
                   "--variant-prep pileup evidence (0 = off; uses the "
                   "quality-aware Python decoder)")
    p.add_argument("--rescue", action="store_true",
                   help="exhaustive-SW rescue of seed-unmapped reads for "
                   "--variant-prep (full-sensitivity mapping; costs "
                   "O(reads x reference) DP on device)")
    p.add_argument("--genotype", action="store_true",
                   help="Pair-HMM diploid genotype likelihoods (GT/GQ/PL) "
                   "for the --variant-prep SNP candidates (second mapping "
                   "pass + batched Pair-HMM forward on device)")
    p.add_argument("--gt-window", type=int, default=50, metavar="W",
                   help="haplotype half-window around each site for "
                   "--genotype (default 50)")
    p.add_argument("--gt-max-reads", type=int, default=64, metavar="N",
                   help="max reads scored per site for --genotype "
                   "(default 64)")
    p.add_argument("--prep-checkpoint", metavar="NPZ", default=None,
                   help="crash-resumable --variant-prep runs: snapshot the "
                   "pileup to this .npz and resume from it if it exists "
                   "(not with --sam-out)")
    p.add_argument("--prep-checkpoint-every", type=int, default=200,
                   metavar="N", help="chunks between --prep-checkpoint "
                   "snapshots (default 200)")
    p.add_argument("--long-align", action="store_true",
                   help="exact SW of two LONG sequences (-1/-2 are FASTA "
                        "paths; --mode sw or sw-affine): the column-strip "
                        "engine, no launch-size cap (the reference errors "
                        "above ~16.7M work items, aligner.rs:436-456)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="--full-wgs: retry a failed file up to N times, "
                   "resuming from its last chunk checkpoint (0 = abort on "
                   "failure, the reference's semantics)")
    p.add_argument("--allow-cpu", action="store_true",
                   help="proceed without an accelerator (reference exits; "
                   "main.rs:76-79)")
    p.add_argument("--env", default=".env", help="path to .env config file")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the run into DIR "
                   "(view with TensorBoard/XProf)")
    return p


def _require_accelerator(allow_cpu: bool, echo=print) -> None:
    import jax

    devs = jax.devices()
    plat = devs[0].platform if devs else "none"
    if plat != "gpu" and not allow_cpu:
        echo("ERROR: no GPU available (use --allow-cpu to override)")
        sys.exit(1)  # GPU-mandatory behavior, main.rs:76-79,160-163


def main(argv: list[str] | None = None, echo=print) -> int:
    args = build_parser().parse_args(argv)
    config_mod.load_dotenv(args.env)  # main.rs:50
    # multi-host bring-up MUST precede any backend use (get_system_info,
    # mesh construction, compile-cache probing all touch jax.devices())
    from mini_parallel.parallel.mesh import initialize_distributed

    initialize_distributed()
    # persistent compile cache: the answer to rebuilding the kernel per
    # launch (the reference recompiled its OpenCL program on every chunk,
    # aligner.rs:504-508 — its top measured bottleneck)
    from mini_parallel.device import enable_compile_cache

    enable_compile_cache()
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
        import atexit

        atexit.register(jax.profiler.stop_trace)

    env = dict(os.environ)
    if args.chunk_size is not None:
        env["GPU_CHUNK_SIZE_READS"] = str(args.chunk_size)
    needs_chunks = args.full_wgs or args.test_wgs or args.files
    cfg = config_mod.get_config(env, require_chunk_size=needs_chunks)
    if args.mode:
        cfg.mode = args.mode

    info = get_system_info()
    echo(info.banner())

    from mini_parallel.models.alignment import AlignmentEngine

    mesh = None
    if cfg.mesh_shape:  # MPT_MESH_SHAPE: shard batches over local chips
        from mini_parallel.parallel.mesh import make_mesh

        # default axis names: ("data",) or ("data", "seq") — duplicate
        # names would silently collapse the Mesh's named shape
        mesh = make_mesh(cfg.mesh_shape)
    engine = AlignmentEngine(cfg, mesh=mesh)

    if args.full_wgs:  # main.rs:72-124
        _require_accelerator(args.allow_cpu, echo)
        from mini_parallel.utils.perf_logger import system_monitors

        distributed_run = bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
        bench_runs: list = []
        with system_monitors() as mon:
            if distributed_run:
                from mini_parallel.parallel.distributed import (
                    process_full_wgs_distributed,
                )

                results, merged = process_full_wgs_distributed(
                    engine, cfg, echo=echo, retries=args.retries)
                echo(f"Global totals: {merged}")
            else:
                from mini_parallel.models.wgs import process_full_wgs_dataset

                results = process_full_wgs_dataset(
                    engine, cfg, echo=echo, retries=args.retries,
                    on_bench=lambda b: bench_runs.append(b.run_number))
        from mini_parallel.utils.perf_logger import summarize_monitor_logs

        if mon.run_dir:
            summary = summarize_monitor_logs(mon.run_dir)
            if summary:
                echo(f"Monitor summary ({mon.run_dir}): {summary}")
                # attach the device-busy evidence (queue-probe percentiles,
                # io/cpu peaks) to the saved benchmark row — the reference
                # got this signal from nvidia-smi dmon (perf_logger.rs:77-82)
                # but then hardcoded 25% into its results (benchmark.rs:159)
                from mini_parallel.utils.bench_tracker import annotate_run

                for rn in bench_runs:
                    annotate_run(rn, {"monitor_summary": summary})
        echo(f"Processed {len(results)} files")
        return 0

    if args.test_wgs:  # main.rs:127-153
        from mini_parallel.io import fastq

        ok = True
        for read in (1, 2):
            name = f"{cfg.sample_id}_L001_R{read}_001.fastq.gz"
            path = os.path.join(cfg.wgs_data_dir, name)
            try:
                bases = fastq.count_bases(path, cfg.chunk_size_reads)
                echo(f"[ok] {name}: {bases} bases")
            except (OSError, IOError) as e:
                echo(f"[fail] {name}: {e}")
                ok = False
        return 0 if ok else 1

    if args.complementarity:
        if not (args.seq1 and args.seq2):
            echo("ERROR: --complementarity requires -1 R1.fastq.gz -2 R2.fastq.gz")
            return 2
        _require_accelerator(args.allow_cpu, echo)
        from mini_parallel.models.complementarity import ComplementarityEngine

        ceng = ComplementarityEngine(cfg, mode=cfg.mode if args.mode else "sw",
                                     mesh=mesh)
        try:
            res = ceng.analyze_lane_pair(args.seq1, args.seq2, progress=echo)
        except (OSError, IOError) as e:
            echo(f"ERROR: {e}")
            return 1
        echo(f"Pairs: {res.pairs}")
        echo(f"Direct score sum: {res.direct_score_sum}")
        echo(f"Complementary score sum: {res.comp_score_sum}")
        echo(f"Perfectly complementary: {res.perfect_pairs}")
        echo(f"Non-complementary: {res.pct_non_complementary:.2f} %")
        echo(f"Time: {res.seconds:.2f} s")
        return 0

    if args.variant_prep:
        if not args.reference:
            echo("ERROR: --variant-prep requires --reference FASTA")
            return 2
        _require_accelerator(args.allow_cpu, echo)
        from mini_parallel.io import fasta
        from mini_parallel.models.variant_prep import (
            VariantPrepEngine,
            write_candidates_vcf,
        )

        if args.sam_out and not args.gapped:
            echo("ERROR: --sam-out requires --gapped (SAM CIGARs come from "
                 "the traceback)")
            return 2
        try:
            recs = fasta.read_fasta(args.reference)
            if not recs:
                raise ValueError(f"no FASTA records in {args.reference}")
            # references always map through the contig table so candidate
            # and VCF coordinates carry the real record names
            veng = VariantPrepEngine(recs, cfg, gapped=args.gapped,
                                     rescue=args.rescue,
                                     min_base_quality=args.min_base_quality,
                                     gap_model=args.gap_model, mesh=mesh)
            vp_paths = args.variant_prep.split(",")
            res = veng.process_file(
                vp_paths if len(vp_paths) > 1 else vp_paths[0], progress=echo,
                sam_out=args.sam_out,
                checkpoint_path=args.prep_checkpoint,
                checkpoint_every=args.prep_checkpoint_every)
            if args.genotype:
                res = veng.genotype_candidates(
                    vp_paths if len(vp_paths) > 1 else vp_paths[0],
                    res, window=args.gt_window,
                    max_reads_per_site=args.gt_max_reads, progress=echo,
                )
        except (OSError, IOError, ValueError) as e:
            echo(f"ERROR: {e}")
            return 1
        echo(f"Reference length: {res.reference_length}")
        echo(f"Reads: {res.total_reads}, mapped: {res.mapped_reads} "
             f"({100*res.mapping_rate:.1f} %)")
        echo(f"Candidate variant sites: {len(res.candidates)}")
        for c in res.candidates[:10]:
            extra = f" GT={c.gt} GQ={c.gq}" if c.gt else ""
            echo(f"  {c.contig}:{c.pos+1}: {c.ref_base}->{c.alt_base} "
                 f"depth={c.depth} alt={c.alt_count}{extra}")
        if args.vcf_out:
            write_candidates_vcf(args.vcf_out, res)
            echo(f"Candidates written to {args.vcf_out}")
        if args.sam_out:
            echo(f"SAM: {res.total_reads} records ({res.mapped_reads} "
                 f"mapped) -> {args.sam_out}")
        return 0

    if args.kmer:
        _require_accelerator(args.allow_cpu, echo)
        from mini_parallel.models.kmer_model import KmerEngine

        eng = KmerEngine(cfg, k=args.kmer_size, canonical=args.canonical,
                         mesh=mesh)
        try:
            km_paths = args.kmer.split(",")
            res = eng.count_file(
                km_paths if len(km_paths) > 1 else km_paths[0], progress=echo,
                checkpoint_path=args.kmer_checkpoint,
                checkpoint_every=args.kmer_checkpoint_every,
                # without --kmer-out the full table is never consumed:
                # summarize device-side instead of draining it (exact
                # distinct/top-N/histogram; ~41.5 MB of wire saved at 13M
                # keys). --kmer-checkpoint needs host folds -> full mode.
                result_mode=("full" if args.kmer_out or args.kmer_checkpoint
                             else "summary"),
            )
        except (OSError, IOError, ValueError) as e:
            echo(f"ERROR: {e}")
            return 1
        echo(f"Total {res.k}-mers: {res.total_kmers}")
        echo(f"Distinct {res.k}-mers: {res.distinct_kmers}")
        echo(f"Reads: {res.total_reads}, time: {res.seconds:.2f} s")
        for s, c in res.top(10):
            echo(f"  {s}  {c}")
        if args.kmer_out:
            n = res.write_counts(args.kmer_out)
            echo(f"Counts: {n} records -> {args.kmer_out}")
        return 0

    if args.long_align:
        if not (args.seq1 and args.seq2):
            echo("ERROR: --long-align requires -1 a.fasta -2 b.fasta")
            return 2
        _require_accelerator(args.allow_cpu, echo)
        if args.mode and args.mode not in ("sw", "sw-affine"):
            echo("ERROR: --long-align supports --mode sw or sw-affine")
            return 2
        # cfg.mode already reflects --mode or the env's MPT_MODE; modes
        # without a long-pair engine (kadane/contiguous defaults) fall
        # back to true SW
        mode = cfg.mode if cfg.mode in ("sw", "sw-affine") else "sw"
        from mini_parallel.io import fasta
        from mini_parallel.ops import sw_long

        try:
            sa = fasta.read_first_sequence(args.seq1)
            sb_ = fasta.read_first_sequence(args.seq2)
        except (OSError, IOError, ValueError) as e:
            echo(f"ERROR: {e}")
            return 1
        echo(f"Sequences: {len(sa)} x {len(sb_)} bases "
             f"({len(sa) * len(sb_) / 1e9:.2f} Gcells, {mode})")
        t0 = time.perf_counter()
        # rows stream along the longer side (fewer, fuller strips)
        a_, b_ = (sa, sb_) if len(sa) >= len(sb_) else (sb_, sa)
        seq_mesh = (mesh if mesh is not None
                    and "seq" in getattr(mesh, "axis_names", ()) else None)
        try:
            if mode == "sw":
                if seq_mesh is not None:
                    score = sw_long.sw_score_long_sharded(
                        a_, b_, seq_mesh, progress=echo)
                else:
                    score = sw_long.sw_score_long(a_, b_, progress=echo)
            elif seq_mesh is not None:
                score = sw_long.sw_affine_score_long_sharded(
                    a_, b_, seq_mesh, gap_open=cfg.gap_open,
                    gap_extend=cfg.gap_extend, progress=echo)
            else:
                score = sw_long.sw_affine_score_long(
                    a_, b_, gap_open=cfg.gap_open,
                    gap_extend=cfg.gap_extend, progress=echo)
        except ValueError as e:  # e.g. band < strip width on a seq mesh
            echo(f"ERROR: {e}")
            return 1
        dt = time.perf_counter() - t0
        echo(f"Alignment score: {score}")
        echo(f"Processing time: {dt:.2f} s "
             f"({len(sa) * len(sb_) / max(dt, 1e-9) / 1e9:.1f} GCUPS)")
        return 0

    if args.files:  # main.rs:170-182
        if not (args.seq1 and args.seq2):
            echo("ERROR: --files requires --seq1 and --seq2 file paths")
            return 2
        _require_accelerator(args.allow_cpu, echo)
        try:
            res = engine.pair_align_files(args.seq1, args.seq2, progress=echo)
        except (OSError, IOError) as e:
            echo(f"ERROR: {e}")
            return 1
        echo(f"Loaded {res.bases1} bases from {args.seq1}")
        echo(f"Loaded {res.bases2} bases from {args.seq2}")
        echo(f"Alignment score: {res.score}")
        echo(f"Processing time: {res.processing_time_ms:.2f} ms on {res.device}")
        return 0

    if args.seq1 and args.seq2:  # main.rs:183-191
        _require_accelerator(args.allow_cpu, echo)
        score = engine.score_strings(args.seq1, args.seq2)
        echo(f"Alignment score: {score}")
        return 0

    build_parser().print_help()
    return 2


def entrypoint() -> None:
    """console_scripts hook (pyproject.toml)."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
