"""Verdict r3 #7: at-scale resilience soak on the 10M-read dataset.

Injects ONE transient failure mid-file-3 (chunk 60 of 125, after the
chunk-50 checkpoint fired at real cadence) and runs with retries=1: the
file must resume from its chunk checkpoint and finish, and every file's
(reads, bases, score) must be bit-exact vs the clean soak's checkpoint.
"""
import json
import os
import sys
import time

from mini_parallel.utils.config import get_config, load_dotenv

load_dotenv()
cfg = get_config()

from mini_parallel.device import enable_compile_cache

enable_compile_cache()
from mini_parallel.io import fastq
from mini_parallel.models.alignment import AlignmentEngine
from mini_parallel.models.wgs import process_full_wgs_dataset

CLEAN_CHECKPOINT = sys.argv[1]  # the clean soak's checkpoint json

real_iter = fastq.iter_read_chunks
state = {"armed": True}


def dying_iter(path, chunk_size, progress=None):
    for i, chunk in enumerate(real_iter(path, chunk_size,
                                        progress=progress)):
        if state["armed"] and "L003" in path and i == 60:
            state["armed"] = False  # transient: next attempt succeeds
            raise RuntimeError("injected transient failure (soak)")
        yield chunk


fastq.iter_read_chunks = dying_iter

eng = AlignmentEngine(cfg, mode="kadane")
t0 = time.perf_counter()
# paths resolve from the INVOKER's cwd (stage a .env + run from a scratch
# dir, e.g. /root/soak_r4) — never from the installed package directory
results = process_full_wgs_dataset(
    eng, cfg, checkpoint_dir=os.environ.get("MPT_SOAK_CKPT_DIR", "./resil"),
    retries=1, results_dir=os.environ.get("MPT_RESULTS_DIR"))
wall = time.perf_counter() - t0

clean = json.load(open(CLEAN_CHECKPOINT))
clean_files = {os.path.basename(f["file_path"]): f
               for f in clean["files"]}
ok = True
for r in results:
    c = clean_files[os.path.basename(r.file_path)]
    same = (r.total_reads == c["total_reads"]
            and r.total_bases == c["total_bases"]
            and r.score == c["score"])
    ok &= same
    print(f"{os.path.basename(r.file_path)}: reads={r.total_reads} "
          f"score={r.score} vs clean score={c['score']} "
          f"{'OK' if same else 'MISMATCH'}", flush=True)
print(json.dumps({
    "metric": "soak_resilience_10M",
    "injected": "file L003 chunk 60 (transient), retries=1",
    "bit_exact_vs_clean": bool(ok),
    "wall_seconds": round(wall, 1),
}), flush=True)
sys.exit(0 if ok else 1)
