"""Figures of the reference's quality gates, for chip_smoke.py's
QUALITY_FIGURES: run the section functions of scripts/quality.py (the JAX
package, here on JAX-CPU) with each backend, and print, for every section
and backend, the hash of its assemblies' transcript sets
(shannon_tpu_torch.quality.transcript_sha256), the hash of the rest of the
section (section_sha256), its headline metrics and its wall seconds.

    JAX_PLATFORMS=cpu python scripts/reference_quality.py [--sections pinned sweep]
        [--backends device oracle] [--host-solver] [--out FILE]

scripts/quality.py is imported by path and run as it is, at its own sizes;
this script writes neither quality.json nor QUALITY.md.  With
--host-solver the device backend's sparse flow uses the oracle's per-node
host solver in place of its batched solver (shannon_tpu/ops/sparseflow.py
solve_nodes_device): the same pairings, in the oracle's order, which is
what the port's batched solver returns.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import shannon_tpu.ops.sparseflow as ref_sparseflow  # noqa: E402
import shannon_tpu.pipeline as ref_pipeline  # noqa: E402
from shannon_tpu.oracle.sparseflow import solve_node  # noqa: E402
from shannon_tpu_torch.quality import (  # noqa: E402
    SECTIONS, headline, section_sha256, transcript_sha256,
)


def _reference():
    spec = importlib.util.spec_from_file_location("ref_quality", REPO / "scripts" / "quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_solver(g, xs, config, edge_flows=None):
    """The oracle's pairings, node by node, for the device backend's hook."""
    return {v: solve_node(g, v, config, edge_flows) for v in xs}


def run(reference, name: str, backend: str) -> dict:
    sets = []
    inner = ref_pipeline.assemble

    def recording(*args, **kw):
        res = inner(*args, **kw)
        sets.append([t.seq for t in res.transcripts])
        return res

    ref_pipeline.assemble = recording
    try:
        t0 = time.perf_counter()
        section = getattr(reference, f"run_{name}")(backend)
        wall = time.perf_counter() - t0
    finally:
        ref_pipeline.assemble = inner
    return {"sha256": transcript_sha256(sets), "section_sha256": section_sha256(section),
            "wall_s": wall, "section": section}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", nargs="+", default=list(SECTIONS), choices=list(SECTIONS))
    ap.add_argument("--backends", nargs="+", default=["device", "oracle"],
                    choices=["device", "oracle"])
    ap.add_argument("--host-solver", action="store_true",
                    help="the device backend with the oracle's host sparse-flow solver")
    ap.add_argument("--out", default=None, help="also write every section's JSON here")
    args = ap.parse_args()
    if args.host_solver:
        ref_sparseflow.solve_nodes_device = host_solver
    reference = _reference()
    report = {}
    for name in args.sections:
        for backend in args.backends:
            r = run(reference, name, backend)
            report.setdefault(name, {})[backend] = r
            print(json.dumps({"section": name, "backend": backend,
                              "host_solver": args.host_solver, "sha256": r["sha256"],
                              "section_sha256": r["section_sha256"],
                              "wall_s": round(r["wall_s"], 1),
                              **headline(name, r["section"])}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
