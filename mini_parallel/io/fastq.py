"""Streaming FASTQ(.gz) reading and read-chunking.

Reproduces the reference's ingestion semantics
(`smith_waterman/src/aligner.rs:107-178`):

- a FASTQ record is 4 lines; the *sequence* is every line where
  ``line_count % 4 == 2`` under 1-based counting (`aligner.rs:138`),
- reads are accumulated into chunks of ``chunk_size_reads`` and handed to a
  caller-supplied processor (`aligner.rs:143-146`),
- per-line read errors are tolerated up to 10, then the file aborts
  (`aligner.rs:155-163`),
- a non-empty final partial chunk is still processed (`aligner.rs:167-170`).

Differences by design (reference defects not replicated):
- gzip decode is in-process (zlib) instead of a spawned ``zcat`` child
  (`aligner.rs:111-120`); a ``zcat`` engine remains available for parity
  testing and as a high-throughput option.
- the C++ native decoder (mini_parallel/native) is used when built,
  giving a multi-threaded decode + batch path; the Python path is the
  always-available fallback with identical semantics.
"""

from __future__ import annotations

import gzip
import io
import os
import shutil
import subprocess
from typing import Callable, Iterator


def open_lines(path: str, engine: str = "auto") -> Iterator[bytes]:
    """Yield raw lines (no trailing newline) from a FASTQ or FASTQ.gz file."""
    if path.endswith(".gz"):
        if engine == "zcat":
            # zcat child-process path, kept for parity with aligner.rs:111-120
            proc = subprocess.Popen(["zcat", path], stdout=subprocess.PIPE)
            assert proc.stdout is not None
            try:
                for line in proc.stdout:
                    yield line.rstrip(b"\r\n")
            finally:
                proc.stdout.close()
                rc = proc.wait()  # reap; the reference leaked zombies here
            if rc != 0:
                # a missing/corrupt .gz must fail like the gzip path does,
                # not read as an empty file
                raise IOError(f"zcat exited {rc} for {path}")
            return
        stream: io.BufferedIOBase = gzip.open(path, "rb")  # type: ignore[assignment]
    else:
        stream = open(path, "rb")
    try:
        for line in stream:
            yield line.rstrip(b"\r\n")
    finally:
        stream.close()


def iter_read_chunks(
    path: str,
    chunk_size_reads: int,
    max_errors: int = 10,
    engine: str = "auto",
    progress_every: int = 1_000_000,
    progress: Callable[[str], None] | None = None,
) -> Iterator[list[bytes]]:
    """Yield lists of sequence lines, ``chunk_size_reads`` at a time.

    Mirrors ``process_fastq_file_in_chunks`` (aligner.rs:107-178) as a
    generator instead of a callback, which composes with prefetching.
    """
    if engine in ("auto", "native"):
        yielded = False
        try:
            from mini_parallel.native import fastq_native

            for chunk in fastq_native.iter_reads_native(path, chunk_size_reads):
                yielded = True
                yield chunk
            return
        except IOError:
            raise
        except Exception:
            if engine == "native" or yielded:
                # once anything reached the consumer, falling through to the
                # Python path would re-read from the start and silently
                # double-count every already-yielded chunk
                raise
            # native plane unavailable: fall through to the Python path

    chunk: list[bytes] = []
    line_count = 0
    total_reads = 0
    error_count = 0
    lines = open_lines(path, engine=engine)
    while True:
        try:
            line = next(lines)
        except StopIteration:
            break
        except (OSError, EOFError) as e:
            # The reference tolerates up to 10 *per-line* decode errors
            # (aligner.rs:155-163) because BufRead::lines can continue past a
            # bad line. A Python stream error (gzip corruption, I/O failure)
            # is not resumable — the generator is dead — so it aborts the
            # file immediately; per-line tolerance lives in the native C++
            # decoder (fastq_reader.cpp), which skips malformed (non-UTF-8)
            # lines without advancing the line counter, exactly like the
            # reference's Err arm, and aborts after >10 of them.
            del error_count, max_errors
            raise IOError(f"Error reading {path} at line {line_count}: {e}") from e
        line_count += 1
        if line_count % 4 == 2:  # sequence line, aligner.rs:138
            chunk.append(line)
            total_reads += 1
            if len(chunk) >= chunk_size_reads:
                yield chunk
                chunk = []
        if progress and line_count % progress_every == 0:
            progress(
                f"Read {line_count} lines, found {total_reads} reads, "
                f"current chunk size: {len(chunk)}"
            )
    if chunk:  # final partial chunk, aligner.rs:167-170
        yield chunk


def iter_flat_chunks(
    path: str,
    chunk_size_reads: int,
    engine: str = "auto",
    progress: Callable[[str], None] | None = None,
) -> Iterator[tuple["np.ndarray", "np.ndarray"]]:
    """Yield chunks as flat (bytes, offsets) NumPy pairs.

    read i of a chunk is ``flat[offs[i]:offs[i+1]]`` (offs[0] == 0,
    offs[-1] == flat.size). This is the native decoder's own wire format
    (fastq_reader.cpp), surfaced without materializing per-read Python
    bytes objects — the list path costs ~1.4 µs/read in object churn,
    which at 10k-read chunks is the single largest host charge in the
    warm --full-wgs loop. Chunk boundaries are identical to
    ``iter_read_chunks`` (same chunk_size_reads), so chunk-index
    checkpoints interoperate.
    """
    import numpy as np

    if engine in ("auto", "native"):
        yielded = False
        try:
            from mini_parallel.native import fastq_native

            for flat, offs in fastq_native.iter_read_chunks_native(
                path, chunk_size_reads
            ):
                yielded = True
                yield flat, offs
            return
        except IOError:
            raise
        except Exception:
            if engine == "native" or yielded:
                raise  # see iter_read_chunks: never re-read after yielding
            # native plane unavailable: fall through to the Python path
    for chunk in iter_read_chunks(
        path, chunk_size_reads,
        engine="python" if engine == "auto" else engine,  # native already
        progress=progress,                                # failed above
    ):
        yield _flatten_rows(chunk)


def _flatten_rows(rows: list) -> tuple:
    """list[bytes] -> the flat (bytes, offsets) contract (offs[0] == 0,
    offs[-1] == flat.size, int64) — the ONE fallback conversion."""
    import numpy as np

    flat = np.frombuffer(b"".join(rows), np.uint8)
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    return flat, offs


def iter_flat_chunks_multi(paths, chunk_size_reads: int, **kw):
    """Flat chunk stream over a file list (see iter_read_chunks_multi)."""
    for p in as_paths(paths):
        yield from iter_flat_chunks(p, chunk_size_reads, **kw)


def iter_flat_chunks_with_quals(
    path: str,
    chunk_size_reads: int,
    engine: str = "auto",
) -> Iterator[tuple["np.ndarray", "np.ndarray", "np.ndarray", "np.ndarray"]]:
    """(seq_flat, seq_offs, qual_flat, qual_offs) chunks — the quals-aware
    flat stream (see iter_flat_chunks for the offsets contract; a record
    with mismatched seq/qual lengths keeps both sides as decoded)."""
    import numpy as np

    if engine in ("auto", "native"):
        yielded = False
        try:
            from mini_parallel.native import fastq_native

            for item in fastq_native.iter_flat_with_quals_native(
                path, chunk_size_reads
            ):
                yielded = True
                yield item
            return
        except IOError:
            raise
        except Exception:
            if engine == "native" or yielded:
                raise  # see iter_read_chunks: never re-read after yielding
            # native plane unavailable: fall through to the Python path

    for seqs, quals in iter_read_chunks_with_quals(
        path, chunk_size_reads, engine="python" if engine == "auto" else engine
    ):
        yield (*_flatten_rows(seqs), *_flatten_rows(quals))


def iter_flat_chunks_with_quals_multi(paths, chunk_size_reads: int, **kw):
    """Quals-aware flat chunk stream over a file list."""
    for p in as_paths(paths):
        yield from iter_flat_chunks_with_quals(p, chunk_size_reads, **kw)


def prefetch(it: Iterator, depth: int = 4) -> Iterator:
    """Run ``it`` in a background thread with a bounded queue.

    Overlaps producer work (gzip decode, record parse, flat-chunk copy)
    with whatever the consumer does per item (pad, 2-bit pack, device
    dispatch) — the reference's loop was strictly serial
    (aligner.rs:143-146 processes each chunk before reading the next).
    NOTE: any progress callback inside the wrapped iterator now fires on
    the producer thread, up to ``depth`` chunks ahead of the consumer.
    Producer exceptions re-raise at the consumer's next pull; abandoning
    the generator stops the producer promptly (no leaked file handles
    blocked on a full queue).
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not _put((None, item)):
                    return
            _put((_END, None))
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            _put((e, None))

    t = threading.Thread(target=run, daemon=True, name="mpt-prefetch")
    t.start()
    try:
        while True:
            kind, item = q.get()
            if kind is _END:
                return
            if kind is not None:
                raise kind
            yield item
    finally:
        stop.set()


def iter_read_chunks_with_quals(
    path: str,
    chunk_size_reads: int,
    engine: str = "auto",
) -> Iterator[tuple[list[bytes], list[bytes]]]:
    """Yield (sequences, quality_strings) chunks (FASTQ lines 2 and 4).

    Uses the native decoder's quals mode when built (background C++ decode
    thread, same speedup as the sequence-only path); the Python path is the
    always-available fallback. Records with mismatched seq/qual lengths are
    yielded as-is — downstream masking treats missing quals as passing.
    """
    if engine in ("auto", "native"):
        yielded = False
        try:
            from mini_parallel.native import fastq_native

            for pair in fastq_native.iter_reads_with_quals_native(
                path, chunk_size_reads
            ):
                yielded = True
                yield pair
            return
        except IOError:
            raise
        except Exception:
            if engine == "native" or yielded:
                raise  # see iter_read_chunks: never re-read after yielding
            # native plane unavailable: fall through to the Python path

    seqs: list[bytes] = []
    quals: list[bytes] = []
    line_count = 0
    for line in open_lines(path, engine="python" if engine == "auto" else engine):
        line_count += 1
        m = line_count % 4
        if m == 2:
            seqs.append(line)
        elif m == 0:
            quals.append(line)
            if len(seqs) >= chunk_size_reads:
                yield seqs, quals
                seqs, quals = [], []
    if seqs:
        while len(quals) < len(seqs):  # truncated final record
            quals.append(b"")
        yield seqs, quals


def process_fastq_file_in_chunks(
    path: str,
    chunk_size_reads: int,
    processor: Callable[[list[bytes]], None],
    **kw,
) -> tuple[int, int]:
    """Callback-style wrapper matching the reference API shape.

    Returns (total_reads, total_chunks).
    """
    total_reads = 0
    chunks = 0
    for chunk in iter_read_chunks(path, chunk_size_reads, **kw):
        processor(chunk)
        total_reads += len(chunk)
        chunks += 1
    return total_reads, chunks


def count_bases(path: str, chunk_size_reads: int = 10_000) -> int:
    """Total sequence bases in a FASTQ file (aligner.rs:535-544)."""
    return sum(int(flat.size)
               for flat, _ in iter_flat_chunks(path, chunk_size_reads))


def count_reads(path: str, chunk_size_reads: int = 10_000) -> int:
    return sum(len(offs) - 1
               for _, offs in iter_flat_chunks(path, chunk_size_reads))


def count_lines(path: str) -> int:
    """Line counter — the ``linecount`` utility bin (tools/linecount.rs:6-30)."""
    return sum(1 for _ in open_lines(path))


def count_lines_stdin(stream=None) -> int:
    """stdin line counter (tools/stdin_linecount.rs:3-21)."""
    import sys

    stream = stream if stream is not None else sys.stdin.buffer
    return sum(1 for _ in stream)


def write_fastq(path: str, reads: list[bytes | str], quality_char: str = "I") -> None:
    """Write a minimal valid FASTQ(.gz) — fixture helper for tests and demos."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:  # type: ignore[arg-type]
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode("ascii")
            f.write(f"@read_{i}\n{r}\n+\n{quality_char * len(r)}\n")


def as_paths(path) -> list[str]:
    """Normalize a str | list[str] input to a list of paths."""
    return [path] if isinstance(path, (str, bytes)) else list(path)


def iter_read_chunks_multi(paths, chunk_size_reads: int, progress=None,
                           **kw):
    """Chunk stream over a FILE LIST: files concatenate in order, so chunk
    indices (and therefore checkpoint resume points) are global across a
    sample's lanes."""
    for p in as_paths(paths):
        yield from iter_read_chunks(p, chunk_size_reads, progress=progress,
                                    **kw)


def iter_read_chunks_with_quals_multi(paths, chunk_size_reads: int, **kw):
    """(sequences, quals) chunk stream over a file list (see
    iter_read_chunks_multi)."""
    for p in as_paths(paths):
        yield from iter_read_chunks_with_quals(p, chunk_size_reads, **kw)
