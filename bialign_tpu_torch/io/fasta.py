"""Minimal FASTA reader.

The reference ships ``Examples/*.fa`` but never parses FASTA in-package
(SURVEY.md L1); this small reader is an addition so the CLI and batch
front ends can consume the shipped FASTA files and multi-record pair streams directly.
"""

from __future__ import annotations

from typing import Iterator, Tuple


def iter_fasta(text: str) -> Iterator[Tuple[str, str]]:
    """Yield ``(header, sequence)`` records from FASTA text."""
    header = None
    chunks: list = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(chunks)
            header = line[1:].strip()
            chunks = []
        else:
            chunks.append(line)
    if header is not None:
        yield header, "".join(chunks)


def read_fasta(filename: str) -> list:
    with open(filename, "r") as fh:
        return list(iter_fasta(fh.read()))


def read_first_sequence(filename: str) -> str:
    records = read_fasta(filename)
    if not records:
        raise IOError(f"No FASTA records in {filename}")
    return records[0][1]
