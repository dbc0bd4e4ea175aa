"""Line counter for FASTQ(.gz) files — tools/linecount.rs parity.

Usage: python -m mini_parallel.tools.linecount FILE [FILE...]
Prefers the native C++ counter; progress every 10M lines like the reference
(linecount.rs:17-20).
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: linecount FILE [FILE...]", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        try:
            try:
                from mini_parallel.native import fastq_native

                n = fastq_native.count_lines_native(path)
            except Exception:
                from mini_parallel.io import fastq

                n = fastq.count_lines(path)
            print(f"{path}: {n} lines")
        except (OSError, IOError) as e:
            print(f"{path}: ERROR {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
