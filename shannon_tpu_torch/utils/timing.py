# Copied from shannon_tpu/utils/timing.py; equal to it apart from this line and the package name in imports.
"""Per-stage timing + structured observability.

The reference writes per-stage wall-clock timestamps to a log file in the
output dir (SURVEY.md §6 'Tracing/profiling'); here every stage records
wall-clock plus domain counters (reads/s, #k-mers kept/dropped,
#components, #transcripts) to `timing.log` (human) and `stats.json`
(machine), and the same dict is returned to callers/benchmarks.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path


class StageTimer:
    def __init__(self, out_dir: str | Path | None = None, echo: bool = True):
        self.out_dir = Path(out_dir) if out_dir else None
        self.echo = echo
        self.stages: dict[str, dict] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def stage(self, name: str, **counters):
        start = time.perf_counter()
        rec = {"start_s": round(start - self._t0, 3)}
        self.stages[name] = rec
        try:
            yield rec
        finally:
            rec["wall_s"] = round(time.perf_counter() - start, 3)
            rec.update(counters)
            self._write_line(name, rec)

    def note(self, name: str, **counters) -> None:
        """Attach counters to an existing stage record (or create one)."""
        rec = self.stages.setdefault(name, {})
        rec.update(counters)

    def _write_line(self, name: str, rec: dict) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {name}: {rec.get('wall_s', '?')}s " + " ".join(
            f"{k}={v}" for k, v in rec.items() if k not in ("start_s", "wall_s")
        )
        if self.echo:
            print(line, flush=True)
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            with open(self.out_dir / "timing.log", "a") as fh:
                fh.write(line + "\n")

    def flush_stats(self, extra: dict | None = None) -> dict:
        stats = {"stages": self.stages}
        if extra:
            stats.update(extra)
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            (self.out_dir / "stats.json").write_text(json.dumps(stats, indent=2))
        return stats
