"""Port parity: the quality driver.  Each section of shannon_tpu_torch.quality
(the port's device backend on the CPU) against the same section function of
the reference's scripts/quality.py on JAX-CPU, with both of the reference's
backends, at the same shrunk sizes; the pinned section on the port's oracle
backend against the reference's oracle backend too.

The reference's script is imported by path and is not edited: its dataset
constants are shrunk on the module object, and its count table's capacity
(AssemblyConfig(kmer_capacity=1 << 20), built inside each section) through
shannon_tpu.config.AssemblyConfig, which also counts in one shard where the
conftest's 8 virtual devices would give eight; both with monkeypatch for
the test's span.  Neither the capacity nor the shards change a result (an
overflow raises; the reference's tests hold its sharded count to its
one-shard count); at 2^20 lanes the reference's device path spends about
20 s an assembly here.

Tolerance: exact — every metric, dataset field and assembly statistic
equal (wall times and backend labels aside), and the same transcript sets
(transcript_sha256 of each section's assemblies, in order).  At these
sizes the reference's two backends agree with each other as well.  The file
took about 60 s on an 8-core x86 CPU."""

import importlib.util
from pathlib import Path

import pytest

import shannon_tpu.config as ref_config
import shannon_tpu.pipeline as ref_pipeline
from shannon_tpu_torch import quality

REPO = Path(__file__).resolve().parent.parent
CAPACITY = 1 << 16

# The shrunk datasets: (reference module constants, the port's arguments).
SIZES = {
    "pinned": ({"N_TRANSCRIPTS": 10, "T_LEN": 500}, {"n_transcripts": 10, "length": 500}),
    "paired_bridging": ({"PB_N_PAIRS": 2}, {"n_pairs": 2}),
    "splicing": ({"SG_GENES": 3}, {"n_genes": 3}),
    "sweep": ({"N_TRANSCRIPTS": 10, "T_LEN": 500, "SWEEP_COVERAGES": (5.0, 20.0)},
              {"n_transcripts": 10, "length": 500, "coverages": (5.0, 20.0)}),
}


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("ref_quality", REPO / "scripts" / "quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(reference, monkeypatch, name: str, backend: str) -> dict:
    """The reference's section at the shrunk sizes, with the hash of the
    transcript sets its assemble() calls returned."""
    for const, value in SIZES[name][0].items():
        monkeypatch.setattr(reference, const, value)
    config = ref_config.AssemblyConfig

    def shrunk(**kw):
        assert kw.pop("kmer_capacity") == quality.KMER_CAPACITY
        return config(kmer_capacity=CAPACITY, n_devices=1, **kw)

    monkeypatch.setattr(ref_config, "AssemblyConfig", shrunk)
    sets = []
    inner = ref_pipeline.assemble

    def recording(*args, **kw):
        res = inner(*args, **kw)
        sets.append([t.seq for t in res.transcripts])
        return res

    monkeypatch.setattr(ref_pipeline, "assemble", recording)
    out = getattr(reference, f"run_{name}")(backend)
    monkeypatch.undo()
    out["sha256"] = quality.transcript_sha256(sets)
    return out


@pytest.mark.parametrize("name", list(SIZES))
def test_section_matches_reference(name, reference, monkeypatch):
    """The port's device backend == the reference's device and oracle
    backends."""
    ref = {b: _run_reference(reference, monkeypatch, name, b) for b in ("device", "oracle")}
    port = quality.SECTIONS[name]("device", "cpu", kmer_capacity=CAPACITY, **SIZES[name][1])
    for b in ("device", "oracle"):
        assert quality.strip_section(port) == quality.strip_section(ref[b]), b
        assert port["sha256"] == ref[b]["sha256"], b
        assert quality.section_sha256(port) == quality.section_sha256(ref[b]), b
    assert port["backend"] == "device"
    if "assembly_stats" in port:
        assert port["assembly_stats"]["backend"] == "torch:cpu"


def test_pinned_oracle_backend_matches_reference(reference, monkeypatch):
    ref = _run_reference(reference, monkeypatch, "pinned", "oracle")
    port = quality.run_pinned("oracle", kmer_capacity=CAPACITY, **SIZES["pinned"][1])
    assert quality.strip_section(port) == quality.strip_section(ref)
    assert port["sha256"] == ref["sha256"]
    assert port["assembly_stats"]["backend"] == "oracle"


def test_transcript_sha256_is_order_and_strand_free_within_a_set():
    a = ["ACGTTT", "GGGCCA"]
    b = ["TGGCCC", "ACGTTT"]  # the reverse complement of the second, reordered
    assert quality.transcript_sha256([a]) == quality.transcript_sha256([b])
    assert quality.transcript_sha256([a, []]) != quality.transcript_sha256([[], a])
    assert len(quality.transcript_sha256([a])) == 16


def test_main_writes_only_its_out_file(tmp_path, monkeypatch, capsys):
    """--out gets the section's JSON; quality.json and QUALITY.md are not
    touched."""
    import json

    before = {p: (REPO / p).read_bytes() for p in ("quality.json", "QUALITY.md")}
    monkeypatch.setattr(quality, "run_pinned", lambda backend, device: {"backend": backend})
    monkeypatch.setitem(quality.SECTIONS, "pinned", quality.run_pinned)
    out = tmp_path / "q.json"
    assert quality.main(["--backend", "oracle", "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == {"pinned": {"backend": "oracle"}}
    assert '"pinned"' in capsys.readouterr().out
    assert {p: (REPO / p).read_bytes() for p in before} == before
    with pytest.raises(SystemExit):
        quality.main(["--sweep", "--splicing"])
