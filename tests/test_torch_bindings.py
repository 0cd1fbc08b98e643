"""The ctypes bindings of the port's CUDA entry points
(shannon_tpu_torch/kernels.py _ARGTYPES) against their C signatures in
shannon_tpu_torch/csrc/*.cu: the same number of parameters, each of the same
kind (a pointer, int64_t, int or float), the stream last.  A binding that
disagrees with its source passes wrong arguments with no error on the CPU,
and only fails on the card."""

import ctypes
import re
from pathlib import Path

import pytest

from shannon_tpu_torch import kernels

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
KINDS = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float}


def c_signatures() -> dict:
    """Each extern "C" entry point's parameter kinds, by name."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(r"\nint (shannon_\w+)\(([^)]*)\)\s*\{", text):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append(ctypes.c_void_p)
                else:
                    kinds.append(KINDS[p.rsplit(" ", 1)[0].replace("const ", "")])
            out[name] = kinds
    return out


SIGNATURES = c_signatures()


def test_every_binding_has_a_c_entry_point():
    assert set(kernels._ARGTYPES) <= set(SIGNATURES), set(kernels._ARGTYPES) - set(SIGNATURES)


@pytest.mark.parametrize("entry", sorted(kernels._ARGTYPES))
def test_binding_matches_its_c_signature(entry):
    want = SIGNATURES[entry]
    assert kernels._ARGTYPES[entry] == want, (entry, kernels._ARGTYPES[entry], want)
    assert want[-1] is ctypes.c_void_p  # the stream
