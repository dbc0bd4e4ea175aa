"""Count lines from stdin — tools/stdin_linecount.rs parity.

Usage: zcat file.fastq.gz | python -m mini_parallel.tools.stdin_linecount
"""

from __future__ import annotations

import sys


def main() -> int:
    n = 0
    for _ in sys.stdin.buffer:
        n += 1
        if n % 10_000_000 == 0:  # stdin_linecount.rs progress cadence
            print(f"... {n} lines", file=sys.stderr)
    print(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
