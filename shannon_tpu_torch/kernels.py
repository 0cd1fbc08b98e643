"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``shannon_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use each is compiled with ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into
``build/kernels/libshannon_kernels.so`` beside the package, and loaded with
``ctypes`` (the same pattern ``shannon_tpu/native`` uses for the ingest
library).  The library is rebuilt whenever the hash of the sources changes.
Nothing here runs at import time: the CPU tests import every module, and only
a call on a CUDA tensor reaches :func:`library`.

There is no fallback.  A missing ``nvcc``, a failed build, a failed load or a
nonzero launch status raises.

Each kernel counts its launches in :attr:`KernelLibrary.launches` so a run can
show that the main path went through it (``chip_smoke.py`` reads them).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libshannon_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = (
    "extract_kmers", "reduce_sorted", "lookup_sorted",
    "thread_rows", "compact_rows", "sf_greedy",
    "probe_lookup", "rescue_rounds", "prune_round", "compact_keep",
    "node_strands", "group_links", "label_round", "cycle_round",
    "contig_reduce", "base_streams",
    "count_histogram", "merge_spectra", "drop_contigs", "clip_remap",
    "abundance_cut", "lookup_counts", "sibling_maxes", "prune_keep",
    "extract_codes", "owner_buckets", "ownership_pack", "ownership_unpack",
    "neighbor_counts", "sf_jobs",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "shannon_extract_kmers": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _P, _P, _P],
    "shannon_extract_codes": [_P, _P, _I64, _I, _I, _I, _I, _I, _P, _P, _P],
    "shannon_reduce_sorted": [_P, _P, _I64, _I64, _P, _I64, _P, _P, _P, _P],
    "shannon_lookup_sorted": [_P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P],
    "shannon_thread_rows": [_P, _P, _P, _P, _P, _I64, _I, _I, *[_P] * 7, _P],
    "shannon_compact_rows": [*[_P] * 7, _I64, _I, _I, _P, _I64, *[_P] * 8, _P],
    "shannon_sf_greedy": [_P, _I64, _I, _I, _P, _P, _P],
    "shannon_sf_jobs": [_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P],
    "shannon_probe_lookup": [_P, _I64, _I, _I, _I, _P, _I64, _P, _P, _P, _P],
    "shannon_rescue_rounds": [*[_P] * 6, _I64, _I, _P, _P, _P, _I64, _P, _P, _P],
    "shannon_prune_round": [_P, _P, _P, _I64, _F, _F, _I, _P, _P, _P],
    "shannon_compact_keep": [_P, _P, _P, _I64, _P, _I64, _P, _P, _P],
    "shannon_node_strands": [_P, _I64, _I, _P, _P, _P],
    "shannon_node_merge": [_P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P],
    "shannon_link_tiles": [_P, _I64, _I, _I64, _P, _I64, _P, _P, _P, _P, _P],
    "shannon_label_rounds": [_P, _I64, _P, _I64, _P, _I, _P, _P, _P],
    "shannon_cycle_rounds": [_P, _P, _I64, _P, _I64, _P, _I, _P, _P],
    "shannon_contig_reduce": [*[_P] * 8, _I64, _I, _I, _P, _I64, *[_P] * 10, _P],
    "shannon_base_streams": [_P, _P, _P, _I64, _I64, _P, _P, _I64, _I, _P, _I64, _P, _P, _P, _P],
    "shannon_count_histogram": [_P, _I64, _I64, _I, _P, _P],
    "shannon_merge_tables": [_P, _P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _P, _P],
    "shannon_drop_contigs": [_P, _P, _I64, _P, _P, _I64, _P, _P, _I64, _P, _P, _P],
    "shannon_clip_remap": [*[_P] * 4, _I64, _P, _P, _I64, _I64, _P, _I64, *[_P] * 8, _I64,
                           *[_P] * 4],
    "shannon_abundance_cut": [_P, _I64, _I64, _I, _P, _P, _P],
    "shannon_abundance_filter": [_P, _P, _I64, _I64, _I, _P, _I64, _P, _P, _P],
    "shannon_lookup_counts": [_P, _P, _I64, _P, _I64, _P, _I64, _P, _I, _P, _P],
    "shannon_sibling_maxes": [_P, _P, _I64, _I64, _I, _I, _P, _I64, _P, _I, _P, _P, _P],
    "shannon_neighbor_counts": [_P, _P, _I64, _I64, _I, _I, _P, _I64, _P, _I, *[_P] * 4, _P],
    "shannon_prune_filter": [_P, _P, _P, _P, _I64, _I64, _F, _P, _I64, _P, _P, _P],
    "shannon_owner_buckets": [_P, _P, _I64, _I, _I64, _P, _I64, _P, _P, _P, _P],
    "shannon_ownership_counts": [_P, _P, _I64, _P, _I, _P, _I64, _P, _P],
    "shannon_ownership_scatter": [_P, _P, _P, _I64, _I, _P, _I64, _P, _P, _I64, _P, _P],
    "shannon_ownership_headers": [_P, _I, _I64, _P, _P],
    "shannon_ownership_unpack": [_P, _I, _I64, _I64, _I64, _P, _I64, _P, _P, _P, _P],
}
# Entry points whose scratch layout lives in their source alone: for each,
# `<entry>_words(n)` gives the int64 words of scratch it takes at size n.
_SCRATCH_SIZED = (
    "shannon_compact_rows", "shannon_label_rounds", "shannon_cycle_rounds", "shannon_base_streams",
    "shannon_clip_remap",
)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from shannon_tpu_torch/csrc at first use"
    )


def build(force: bool = False) -> tuple[Path, str]:
    """Compile the kernel library if the sources changed.  Returns (path,
    compiler log); the log is empty when the cached build was reused."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _source_hash()
    if not force and lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, _obj, proc in jobs:
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
        objs = [str(obj) for _src, obj, _proc in jobs]
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *objs], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _src, obj, _proc in jobs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    stamp.write_text(digest)
    return lib, "".join(log)


class KernelLibrary:
    """The loaded kernel library plus per-kernel launch counts."""

    def __init__(self, path: Path):
        self.path = path
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in _SCRATCH_SIZED:
            fn = getattr(self._lib, f"{name}_words")
            fn.argtypes = [_I64]
            fn.restype = _I64
        self._lib.shannon_error_string.argtypes = [ctypes.c_int]
        self._lib.shannon_error_string.restype = ctypes.c_char_p
        self.launches = {name: 0 for name in KERNELS}

    def reset_counts(self) -> None:
        for name in self.launches:
            self.launches[name] = 0

    def call(self, entry: str, device: torch.device, *args) -> None:
        """Launch C entry point `entry` on `device`'s current stream and
        raise if the launch was refused.  Pointers are passed as ints."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(self._lib, entry)(*args, stream)
        if err != 0:
            msg = self._lib.shannon_error_string(err).decode()
            raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")

    def scratch_words(self, entry: str, n: int) -> int:
        """Int64 words of scratch C entry point `entry` takes at size `n`."""
        return getattr(self._lib, f"{entry}_words")(n)

    def count(self, kernel: str) -> None:
        self.launches[kernel] += 1


_lock = threading.Lock()
_library: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The process-wide kernel library, built and loaded at first call."""
    global _library
    with _lock:
        if _library is None:
            path, _log = build()
            _library = KernelLibrary(path)
        return _library


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's SM count (K16's, K21's, K22's and K28's grids, K24's plan),
    looked up once a process."""
    return _sm_count(device.index)


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None for an absent optional buffer)."""
    return None if t is None else t.data_ptr()


# Lanes a tile of the single-pass scan takes (SCAN_TILE in csrc/scan.cuh; the
# entry points refuse a scratch sized for any other tile).
SCAN_TILE = 4096
_SCAN_VALUE_MASK = (1 << 62) - 1


def scan_scratch(lanes: int, device) -> torch.Tensor:
    """Zeroed scratch of the single-pass scan over `lanes` lanes (K2, K10,
    K14, K17, K18, K27):
    a ticket word and one status word a tile (csrc/scan.cuh)."""
    return torch.zeros(-(-lanes // SCAN_TILE) + 1, dtype=torch.int64, device=device)


def scan_total(scratch: torch.Tensor) -> int:
    """The scan's total, read back once after the launch: the value of the
    last tile's inclusive status word (0 with no tile)."""
    if scratch.shape[0] == 1:
        return 0
    return int(scratch[-1]) & _SCAN_VALUE_MASK


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel input: on CUDA, of `dtype` and rank, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
