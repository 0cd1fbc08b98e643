"""The port stands alone: no module of shannon_tpu_torch, no line of
chip_smoke.py and no port script imports shannon_tpu (or jax), and each of
the port's copies of the reference's framework-free modules equals its
source apart from its header comment and the package name in imports, so
neither package can drift from the other silently.

Tolerance: exact text equality after that normalization."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "shannon_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch.py"]

# The port's verbatim copies, by path inside each package.
COPIES = [
    "config.py", "io/__init__.py", "io/dna.py", "io/fastx.py", "io/pack.py", "sim.py",
    "eval.py", "utils/__init__.py", "utils/timing.py", "oracle/__init__.py",
    "oracle/assemble.py", "oracle/correction.py", "oracle/counting.py", "oracle/graph.py",
    "oracle/multibridge.py", "oracle/nodegraph.py", "oracle/sparseflow.py",
]
_PORT_IMPORT = re.compile(r"^(\s*(?:from|import) )shannon_tpu_torch(?=[. ])", re.M)


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_reference(path):
    names = list(_imported_names(ast.parse(path.read_text(), filename=str(path))))
    bad = [n for n in names if n.split(".")[0] in ("shannon_tpu", "jax", "jaxlib")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source(rel):
    header, body = (PORT / rel).read_text().split("\n", 1)
    assert header.startswith(f"# Copied from shannon_tpu/{rel};"), header
    assert _PORT_IMPORT.sub(r"\1shannon_tpu", body) == (REPO / "shannon_tpu" / rel).read_text()


def test_native_source_equals_its_source():
    header, body = (PORT / "native" / "ingest.cpp").read_text().split("\n", 1)
    assert header.startswith("// Copied from native/ingest.cpp;"), header
    assert body == (REPO / "native" / "ingest.cpp").read_text()


def test_native_library_is_keyed_on_source_and_host(monkeypatch):
    """A tree copied to another machine (or with an edited ingest.cpp)
    builds its own library: -march=native code is never loaded on a CPU it
    was not built for."""
    from shannon_tpu_torch import native

    name = native._lib_name()
    assert name == native._lib_name()
    monkeypatch.setattr(native, "_host_cpu", lambda: "another CPU")
    assert native._lib_name() != name
