# Copied from shannon_tpu/io/__init__.py; equal to it apart from this line and the package name in imports.
"""Host-side I/O + encoding layer (reference L1, SURVEY.md §2).

FASTA/FASTQ parsing, 2-bit packing, reverse-complement handling, and the
array containers that cross the host<->device boundary.
"""

from shannon_tpu_torch.io.dna import (  # noqa: F401
    BASE_A,
    BASE_C,
    BASE_G,
    BASE_T,
    BASE_INVALID,
    decode_seq,
    encode_seq,
    revcomp_codes,
    revcomp_str,
)
from shannon_tpu_torch.io.fastx import (  # noqa: F401
    read_fasta,
    read_fastq,
    read_fastx,
    write_fasta,
)
from shannon_tpu_torch.io.pack import ReadBatch, pack_reads  # noqa: F401
