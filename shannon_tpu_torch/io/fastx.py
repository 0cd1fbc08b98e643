# Copied from shannon_tpu/io/fastx.py; equal to it apart from this line and the package name in imports.
"""FASTA/FASTQ streaming parsers and writers (reference L1, SURVEY.md §2).

The reference parses FASTA/FASTQ in Python line loops; here parsing is a
thin streaming generator (optionally accelerated by the native C++ ingest
extension, see ``shannon_tpu/native``) that feeds fixed-size packed batches
to the device.  Supports single-end and paired-end (left/right) inputs,
plain or gzip-compressed.
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path
from typing import Iterable, Iterator, Sequence


def _open_text(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "rt", encoding="ascii")


def _sniff_format(path: str | Path) -> str:
    """Return 'fasta' or 'fastq' from the first non-empty character."""
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                return "fasta"
            if line.startswith("@"):
                return "fastq"
            raise ValueError(f"{path}: unrecognized first record char {line[0]!r}")
    raise ValueError(f"{path}: empty file")


def read_fasta(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence) from a FASTA file (multi-line records ok)."""
    header = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip()
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


def read_fastq(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence) from a FASTQ file (qualities discarded —
    the pipeline's error model is k-mer-abundance based, like the
    reference's; SURVEY.md §3.1)."""
    with _open_text(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            h = h.rstrip()
            if not h:
                continue
            if not h.startswith("@"):
                raise ValueError(f"{path}: bad FASTQ header line {h[:40]!r}")
            seq = fh.readline().rstrip()
            plus = fh.readline()
            qual = fh.readline()
            if not qual:
                raise ValueError(f"{path}: truncated FASTQ record {h[:40]!r}")
            del plus, qual
            yield h[1:].strip(), seq


def read_fastx(path: str | Path) -> Iterator[tuple[str, str]]:
    """Auto-detect FASTA vs FASTQ and yield (header, sequence)."""
    fmt = _sniff_format(path)
    return read_fasta(path) if fmt == "fasta" else read_fastq(path)


def read_sequences(path: str | Path) -> list[str]:
    return [seq for _, seq in read_fastx(path)]


def interleave_pairs(
    left: str | Path, right: str | Path
) -> Iterator[tuple[str, str]]:
    """Yield records from paired files interleaved (L0, R0, L1, R1, ...),
    the layout the read-batch packer expects for paired-end input (mate of
    read 2i is read 2i+1)."""
    it_l, it_r = read_fastx(left), read_fastx(right)
    for (hl, sl), (hr, sr) in zip(it_l, it_r, strict=True):
        yield hl, sl
        yield hr, sr


def write_fasta(
    path: str | Path,
    records: Iterable[tuple[str, str]] | Sequence[tuple[str, str]],
    width: int = 80,
) -> int:
    """Write (header, sequence) records as FASTA; returns record count."""
    n = 0
    with open(path, "wt", encoding="ascii") as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width])
                fh.write("\n")
            n += 1
    return n
