"""Time kernels of several trees in turns on one card: K6 (sf_greedy, the
sparse-flow greedy with restarts), K22 (sibling_maxes), K10 (compact_keep),
K2 (reduce_sorted, three inputs), K7 (probe_lookup, both probe sets), K3
(lookup_sorted, two inputs), K4 (thread_rows) and K8 (the dead-end rescue,
one round and the main path's loop), on the same inputs for every tree, so a
change to a kernel's source can be held against its parent within one call.

    python scripts/kernel_turns.py --trees OLD NEW NEW OLD [--out FILE]

Each tree runs in a fresh process that imports that tree's
shannon_tpu_torch and builds its kernels into that tree's build/ (a tree is
a checkout, e.g. a parent unpacked with git archive into a git-ignored
directory).  Inputs, made once from seeds on the host with the plain
versions: K6 on chip_smoke.py's 4,096 random jobs (_sf_jobs(7, 4096)) at
sf_restarts = 4, where the wrapper's launches weigh as much as the kernel,
and on 65,536 such jobs, where the kernel dominates; K22 on a canonical
k = 24 table of 2^21 lanes holding 2^20 random real keys; K10 at
chip_smoke.py's shape (12,582,912 lanes, 10,689,722 of them real random
sorted keys, 3,653,479 of those kept at random); K2 on chip_smoke.py's
kernel-phase inputs (the sorted window keys of 65,536 random 100 bp reads,
k = 24, canonical, into 2^22 lanes: "unit"; the sorted union of two such
tables with their counts: "merge") and on the first read batch of its
1,000,000-read scale dataset ("batch", what the main path gives K2), all
built by chip_smoke.window_keys.  K7 and K3 on the main path's own
inputs, built once on the card by this checkout's kernels (each is exact
against its plain version, so every tree gets the same arrays): K7 on the
counted, shrunk spectrum of the 1,000,000-read scale dataset at the default
AssemblyConfig (12,582,912 lanes, k = 24, canonical), "sib" and "ext"; K3
("lookup_main") on that dataset's node table after tip clip
(pipeline.spectrum_device on all of its reads, 4,194,304 lanes) queried with
its first read batch's non-canonical windows, as threading queries it; and
K3 ("lookup_random") on chip_smoke.py's kernel-phase row (the canonical
windows of 65,536 random reads in the unit table of K2's input).  Beside
each, torch.searchsorted on the same table and queries (K7's probes
materialized by probe_keys), timed in the same process.  K4 on the rows
threading gives it for that first batch (K3's answers for its windows);
K8 on the counted spectrum's probe tables (resolved by each tree's K7) and
its counts after the auto abundance cut: "rescue_1" one round,
"rescue_loop" the main path's call, k + 2 rounds with the break (a tree
without rescue_rounds runs its correct_spectrum's loop of rescue_round
calls, a host read of the changed flag a round).  Times: CUDA events
around 200 calls (20 for K7 and its searchsorted and for the rescue loop),
the median of 5 such windows, after a warm-up.  After the timings each tree
traces 20 calls (5 of the rescue loop) of K10, of each K2 input, of each K7
and K3 input and its searchsorted, of K4 and of both K8 rows with
torch.profiler and reports the device time a call of every kernel and copy
they launched ("device_us"), so the window's time splits into device work
and the card's idle gaps; for one call of the rescue loop it also lists
every launch's device time in order ("rescue_loop_launch_us": a round a
launch).  K1 (extract_kmers) on three inputs: the 1,000,000-read scale
dataset's first read batch packed as the count packs it (65,536 x 128 pad,
k = 24, no mask), canonical as the count extracts it ("extract_count") and
non-canonical as threading does ("extract_thread"), and chip_smoke.py's
masked kernel-phase batch (_random_batch(1, True), canonical:
"extract_masked").  K17 (merge_at, the count's merge) on the batch tables
of that dataset's count at the default AssemblyConfig, built once on the
card by this checkout's kernels (each is exact against its plain version,
so every tree merges the same arrays): the count's first merge
("merge_first", two 4,194,304-lane batch tables), its largest, the last
merge_spectra_sized call ("merge_largest": the running total near 12.6M
lanes and the last batch), and all of the count's merges replayed through
ops.count.merge_batch from its 16 batch tables ("merge_replay", 20
replays a window, the host reads of n included).  Each K1 and K17 row has
its device_us.  Prints one JSON line per tree and, with --out, writes them
all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _search_inputs() -> dict:
    """K7's and K3's inputs (numpy), built on the card."""
    import torch

    from chip_smoke import BATCH_READS, KERNEL_K, KERNEL_PAD, _random_batch, _scale_dataset
    from chip_smoke import window_keys
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import count_reads_spectrum, reduce_sorted, shrink_spectrum
    from shannon_tpu_torch.ops.count import upload_words
    from shannon_tpu_torch.ops.correction import auto_min_abundance
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.ops.spectrum import lookup_sorted
    from shannon_tpu_torch.pipeline import spectrum_device

    dev, cfg = torch.device("cuda", 0), AssemblyConfig()
    reads = _scale_dataset(1_000_000)[1]
    spec = shrink_spectrum(count_reads_spectrum(
        pack_reads(reads, pad_length=cfg.read_pad_length), k=cfg.k, capacity=cfg.kmer_capacity,
        canonical=not cfg.strand_specific, batch_reads=cfg.batch_reads, device=dev,
    ))
    _spec, ca = spectrum_device(pack_reads(reads, pad_length=cfg.read_pad_length), cfg, dev)
    batch = pack_reads(reads[:BATCH_READS], pad_length=128)
    m = batch.mask_rows(0, batch.n_reads)
    windows, valid = extract_kmers_packed(
        upload_words(batch.words, dev), torch.from_numpy(batch.lengths).to(dev), cfg.k, False,
        batch.pad_length, None if m is None else upload_words(m, dev),
    )
    words, lengths, _ = _random_batch(1, False, dev)
    r_query = extract_kmers_packed(words, lengths, KERNEL_K, True, KERNEL_PAD)[0]
    r_table = reduce_sorted(window_keys(dev, seed=1), None, 1 << 22)[0]
    t_idx, t_hit = lookup_sorted(ca.node_key, windows)
    out = {"p_key": spec.key, "p_count": spec.count, "node_key": ca.node_key,
           "windows": windows, "r_table": r_table, "r_query": r_query, "t_idx": t_idx,
           "t_hit": t_hit, "t_valid": valid, "node_cid": ca.node_cid, "node_off": ca.node_off}
    out = {name: x.cpu().numpy() for name, x in out.items()}
    out["cut"], out["k"] = auto_min_abundance(spec), cfg.k
    out.update(_merge_inputs(reads, cfg, dev))
    torch.cuda.empty_cache()
    return out


def _merge_inputs(reads, cfg, dev) -> dict:
    """K1's and K17's inputs (numpy): the first read batch of `reads` packed
    as count_reads_spectrum packs it, chip_smoke.py's masked kernel-phase
    batch, the count's batch tables (their real lanes and n), and the
    arguments of its last merge_at call, recorded while the batch tables
    are merged through merge_batch here."""
    import numpy as np
    import torch

    from chip_smoke import _random_batch
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops import count as tcount

    batch = pack_reads(reads, pad_length=cfg.read_pad_length)
    first = min(cfg.batch_reads, batch.n_reads)
    if batch.mask_rows(0, first) is not None:
        raise RuntimeError("the scale dataset's first read batch has a mask")
    out = {"e_words": batch.words[:first].view(np.int32), "e_lengths": batch.lengths[:first],
           "e_pad": batch.pad_length}
    words, lengths, mask = _random_batch(1, True, torch.device("cpu"))
    out.update(m_words=words.numpy(), m_lengths=lengths.numpy(), m_mask=mask.numpy())

    parts = []
    for s in range(0, batch.n_reads, cfg.batch_reads):
        e = min(s + cfg.batch_reads, batch.n_reads)
        m = batch.mask_rows(s, e)
        parts.append(tcount.count_spectrum_packed(
            tcount.upload_words(batch.words[s:e], dev),
            torch.from_numpy(batch.lengths[s:e]).to(dev), cfg.k, cfg.kmer_capacity,
            not cfg.strand_specific, length=batch.pad_length,
            mask=None if m is None else tcount.upload_words(m, dev),
        ))
    calls, merge_at = [], tcount.merge_at

    def recorded(a, b, cap):
        calls.append((a, b, cap))
        return merge_at(a, b, cap)

    tcount.merge_at = recorded
    try:
        total = None
        for part in parts:
            total = tcount.merge_batch(total, part)
    finally:
        tcount.merge_at = merge_at
    a, b, cap = calls[-1]

    def real(name: str, specs) -> dict:
        n = [min(x.n, x.capacity) for x in specs]
        return {f"{name}_key": np.concatenate([x.key[:c].cpu().numpy() for x, c in zip(specs, n)]),
                f"{name}_count": np.concatenate([x.count[:c].cpu().numpy()
                                                 for x, c in zip(specs, n)]),
                f"{name}_n": np.array([x.n for x in specs]),
                f"{name}_cap": np.array([x.capacity for x in specs])}

    out.update(**real("parts", parts), **real("largest", (a, b)), largest_out=cap,
               merge_calls=len(calls), replay_n=total.n)
    return out


def _inputs(path: Path) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from chip_smoke import _scale_dataset, _sf_jobs, window_keys
    from shannon_tpu_torch.ops.count import reduce_sorted_plain

    rng = np.random.default_rng(22)
    k, lanes = 24, 1 << 21
    keys = np.unique(rng.integers(0, 1 << (2 * k), 1 << 20, dtype=np.int64))
    table = np.full(lanes, (1 << 63) - 1, np.int64)
    table[: len(keys)] = keys
    counts = np.zeros(lanes, np.int32)
    counts[: len(keys)] = rng.integers(1, 50, len(keys))

    # K10: chip_smoke.py's correction-phase shape, made at random
    C, real, kept = 12_582_912, 10_689_722, 3_653_479
    rng = np.random.default_rng(10)
    c_key = np.full(C, (1 << 63) - 1, np.int64)
    c_key[:real] = np.sort(rng.choice(1 << 48, size=real, replace=False))
    c_count = np.zeros(C, np.int32)
    c_count[:real] = rng.integers(1, 50, real)
    c_keep = np.zeros(C, bool)
    c_keep[rng.choice(real, size=kept, replace=False)] = True

    # K2: chip_smoke.py's kernel-phase keys and the scale dataset's first
    # read batch, built by its window_keys on the host
    cpu, cap = torch.device("cpu"), 1 << 22
    unit = window_keys(cpu, seed=1)
    ta = reduce_sorted_plain(unit, None, cap)
    tb = reduce_sorted_plain(window_keys(cpu, seed=2), None, cap)
    mkeys, order = torch.sort(torch.cat([ta[0], tb[0]]))
    mcounts = torch.cat([ta[1], tb[1]])[order]
    bkeys = window_keys(cpu, reads=_scale_dataset(1_000_000)[1])
    np.savez(path, buf=_sf_jobs(7, 4096), big=_sf_jobs(8, 65_536), key=table, count=counts,
             n=len(keys), c_key=c_key, c_count=c_count, c_keep=c_keep, unit=unit.numpy(),
             mkeys=mkeys.numpy(), mcounts=mcounts.numpy(),
             bkeys=bkeys.numpy(), **_search_inputs())


def _device_us(fn, calls: int = 20) -> dict:
    """Device microseconds a call of each kernel and copy fn launches, from
    a torch.profiler trace of `calls` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key[:60]] = us / calls
    return out


def _launch_us(fn) -> list:
    """(kernel or copy, device us) of every launch of one call of fn, in
    launch order, from a torch.profiler trace after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(evt.name[:40], evt.device_time) for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA]


def _child(tree: str, inputs: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import shannon_tpu_torch
    from shannon_tpu_torch.ops import correction as tcor
    from shannon_tpu_torch.ops.correction import compact, probe_resolve
    from shannon_tpu_torch.ops.thread import thread_windows
    from shannon_tpu_torch.ops import count as count_module
    from shannon_tpu_torch.ops.count import Spectrum, merge_at, merge_at_plain, merge_batch
    from shannon_tpu_torch.ops.count import reduce_sorted
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.ops.sparseflow import batched_greedy_packed
    from shannon_tpu_torch.ops.spectrum import lookup_sorted, probe_keys, sibling_maxes

    assert Path(shannon_tpu_torch.__file__).resolve().is_relative_to(Path(tree).resolve())
    dev = torch.device("cuda", 0)
    d = np.load(inputs)

    def on_card(name: str) -> torch.Tensor:
        return torch.from_numpy(d[name]).to(dev)

    buf, big = on_card("buf"), on_card("big")
    spec = Spectrum(key=on_card("key"), count=on_card("count"), n=int(d["n"]))
    table = Spectrum(key=on_card("c_key"), count=on_card("c_count"), n=int(d["c_key"].shape[0]))
    keep = on_card("c_keep")
    unit, mkeys, mcounts, bkeys = (on_card(x) for x in ("unit", "mkeys", "mcounts", "bkeys"))
    cap = 1 << 22
    p_key = on_card("p_key")
    probes = Spectrum(key=p_key, count=torch.ones_like(p_key, dtype=torch.int32),
                      n=int((d["p_key"] != (1 << 63) - 1).sum()))
    lookups = {"lookup_main": (on_card("node_key"), on_card("windows")),
               "lookup_random": (on_card("r_table"), on_card("r_query"))}

    def spectra(name: str) -> list:
        """The tables _merge_inputs saved under `name`, PAD past n."""
        out, at = [], 0
        for n, cap in zip(d[f"{name}_n"].tolist(), d[f"{name}_cap"].tolist()):
            c = min(n, cap)
            key = torch.full((cap,), (1 << 63) - 1, dtype=torch.int64, device=dev)
            count = torch.zeros(cap, dtype=torch.int32, device=dev)
            key[:c] = torch.from_numpy(d[f"{name}_key"][at:at + c]).to(dev)
            count[:c] = torch.from_numpy(d[f"{name}_count"][at:at + c]).to(dev)
            out.append(Spectrum(key=key, count=count, n=n))
            at += c
        return out

    # K1 on the count's and threading's first batch and the masked batch;
    # K17 on the count's first and largest merges and its whole replay
    e_args = (on_card("e_words"), on_card("e_lengths"), int(d["k"]))
    extracts = {
        "extract_count": (*e_args, True, int(d["e_pad"]), None),
        "extract_thread": (*e_args, False, int(d["e_pad"]), None),
        "extract_masked": (on_card("m_words"), on_card("m_lengths"), 24, True, 128,
                           on_card("m_mask")),
    }
    parts = spectra("parts")
    merges = {"merge_first": (parts[0], parts[1], parts[0].capacity),
              "merge_largest": (*spectra("largest"), int(d["largest_out"]))}

    def replay() -> Spectrum:
        total = None
        for part in parts:
            total = merge_batch(total, part)
        return total

    calls = 0

    def counted_merge(*args):
        nonlocal calls
        calls += 1
        return merge_at(*args)

    count_module.merge_at = counted_merge
    try:
        replayed = replay()
    finally:
        count_module.merge_at = merge_at
    if (calls, replayed.n) != (int(d["merge_calls"]), int(d["replay_n"])):
        raise AssertionError(f"the replay made {calls} merges to n = {replayed.n}, not "
                             f"{int(d['merge_calls'])} to {int(d['replay_n'])}")
    for name, args in merges.items():
        got, want = merge_at(*args), merge_at_plain(*args)
        if got.n != want.n or not (torch.equal(got.key, want.key)
                                   and torch.equal(got.count, want.count)):
            raise AssertionError(f"{name}: K17 disagrees with merge_at_plain")

    def median_ms(fn, reps: int = 200, windows: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(windows):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return sorted(times)[windows // 2]

    search = {}
    for side in ("sib", "ext"):
        q = probe_keys(p_key, 24, side, True)
        search[f"probe_lookup_{side}"] = (lambda s=side: probe_resolve(probes, 24, True, s),
                                          lambda q=q: torch.searchsorted(p_key, q), 20)
    for name, (keys, queries) in lookups.items():
        search[name] = (lambda t=keys, q=queries: lookup_sorted(t, q),
                        lambda t=keys, q=queries: torch.searchsorted(t, q.reshape(-1)), 200)
    # K4 on the first batch's rows; K8 from the 1M spectrum's cut counts, at
    # one round and as the main path's loop (a tree without rescue_rounds
    # runs its own loop of rescue_round calls, as its correct_spectrum did)
    threading = [on_card(x) for x in ("t_idx", "t_hit", "t_valid", "node_cid", "node_off")]
    k, cut = int(d["k"]), int(d["cut"])
    counted = Spectrum(key=p_key, count=on_card("p_count"), n=probes.n)
    sib = probe_resolve(counted, k, True, "sib")
    ext = probe_resolve(counted, k, True, "ext")
    raw, counts = tcor.cut_counts(counted, cut)
    if hasattr(tcor, "rescue_rounds"):
        def rescue(rounds):
            return tcor.rescue_rounds(counts, raw, *sib, *ext, rounds)[0]
    else:
        def rescue(rounds):
            c = counts
            for _ in range(rounds):
                nxt, changed = tcor.rescue_round(c, raw, *sib, *ext)
                if not changed:
                    break
                c = nxt
            return c
    loops = {"thread_rows": (lambda: thread_windows(*threading), 200),
             "rescue_1": (lambda: rescue(1), 200),
             "rescue_loop": (lambda: rescue(k + 2), 20)}

    search_ms = {}
    for name, (fn, library, reps) in search.items():
        search_ms[f"{name}_ms"] = median_ms(fn, reps)
        search_ms[f"{name}_searchsorted_ms"] = median_ms(library, reps)

    row = {
        "tree": tree,
        "sf_greedy_ms": median_ms(lambda: batched_greedy_packed(buf, 4)),
        "sf_greedy_65536_ms": median_ms(lambda: batched_greedy_packed(big, 4)),
        "sibling_maxes_ms": median_ms(lambda: sibling_maxes(spec, 24, True)),
        "compact_keep_ms": median_ms(lambda: compact(table, keep)),
        "compact_keep_n": compact(table, keep).n,
        "reduce_sorted_unit_ms": median_ms(lambda: reduce_sorted(unit, None, cap)),
        "reduce_sorted_merge_ms": median_ms(lambda: reduce_sorted(mkeys, mcounts, cap)),
        "reduce_sorted_batch_ms": median_ms(lambda: reduce_sorted(bkeys, None, cap)),
        "reduce_sorted_n": [reduce_sorted(x, c, cap)[3]
                            for x, c in ((unit, None), (mkeys, mcounts), (bkeys, None))],
        **search_ms,
        **{f"{name}_ms": median_ms(fn, reps) for name, (fn, reps) in loops.items()},
        "rescue_loop_rescued": int((rescue(k + 2) != counts).sum()),
        "rescue_loop_launch_us": _launch_us(lambda: rescue(k + 2)),
        "thread_rows_events": int(thread_windows(*threading)[2].sum()),
        **{f"{name}_ms": median_ms(lambda a=args: extract_kmers_packed(*a))
           for name, args in extracts.items()},
        **{f"{name}_ms": median_ms(lambda a=args: merge_at(*a)) for name, args in merges.items()},
        "merge_replay_ms": median_ms(replay, 20),
        "merge_n": [merge_at(*args).n for args in merges.values()] + [replayed.n],
        "merge_replay_calls": calls,
        "card": torch.cuda.get_device_name(0),
        # after the timings, so the traces cannot disturb them
        "device_us": {
            "compact_keep": _device_us(lambda: compact(table, keep)),
            "reduce_sorted_unit": _device_us(lambda: reduce_sorted(unit, None, cap)),
            "reduce_sorted_merge": _device_us(lambda: reduce_sorted(mkeys, mcounts, cap)),
            "reduce_sorted_batch": _device_us(lambda: reduce_sorted(bkeys, None, cap)),
            **{name: _device_us(fn) for name, (fn, _lib, _reps) in search.items()},
            **{name: _device_us(fn, 5 if name == "rescue_loop" else 20)
               for name, (fn, _reps) in loops.items()},
            **{f"{name}_searchsorted": _device_us(lib) for name, (_fn, lib, _r) in search.items()},
            **{name: _device_us(lambda a=args: extract_kmers_packed(*a))
               for name, args in extracts.items()},
            **{name: _device_us(lambda a=args: merge_at(*a)) for name, args in merges.items()},
            "merge_replay": _device_us(replay, 5),
        },
    }
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", nargs=2, metavar=("TREE", "INPUTS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(*args.child)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.npz"
        _inputs(inputs)
        for tree in args.trees:
            proc = subprocess.run(
                [sys.executable, __file__, "--trees", tree, "--child", tree, str(inputs)],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return proc.returncode
            rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps({**rows[-1], "smi": smi}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
