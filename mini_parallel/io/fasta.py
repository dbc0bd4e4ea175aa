"""Minimal FASTA(.gz) reading for reference sequences (variant-call prep)."""

from __future__ import annotations

from mini_parallel.io.fastq import open_lines


def read_fasta(path: str) -> dict[str, bytes]:
    """{name: sequence} for every record in a FASTA(.gz) file."""
    out: dict[str, bytes] = {}
    name = None
    parts: list[bytes] = []
    for line in open_lines(path, engine="python"):
        if line.startswith(b">"):
            if name is not None:
                out[name] = b"".join(parts)
            fields = line[1:].split()
            name = fields[0].decode() if fields else ""
            parts = []
        elif name is not None:
            parts.append(line.strip().upper())
    if name is not None:
        out[name] = b"".join(parts)
    return out


def read_first_sequence(path: str) -> bytes:
    recs = read_fasta(path)
    if not recs:
        raise ValueError(f"no FASTA records in {path}")
    return next(iter(recs.values()))


def write_fasta(path: str, records: dict[str, bytes | str]) -> None:
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:  # type: ignore[arg-type]
        for name, seq in records.items():
            if isinstance(seq, bytes):
                seq = seq.decode("ascii")
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i : i + 70] + "\n")
