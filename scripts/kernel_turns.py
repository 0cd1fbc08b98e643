"""Time kernels of several trees in turns on one card: K6 (sf_greedy, the
sparse-flow greedy with restarts, three inputs), K15 (base_streams), K10
(compact_keep), K2 (reduce_sorted, three inputs), K7
(probe_lookup, both probe sets), K3 (lookup_sorted, two inputs), K4
(thread_rows), K8 (the dead-end rescue, one round and the main path's
loop), K9 (the sibling prune, one round and the main path's loop), K1,
K17, K5, K11, K12, K13's label stage and K14 (reduce_stage), on the same
inputs for every tree, so a change to a kernel's source can be held
against its parent within one call.

    python scripts/kernel_turns.py --trees OLD NEW NEW OLD [--out FILE]
    python scripts/kernel_turns.py --only sf streams clip --trees OLD NEW NEW OLD
    python scripts/kernel_turns.py --only hist lookup --trees OLD NEW NEW OLD
    python scripts/kernel_turns.py --only owner cut --trees OLD NEW NEW OLD
    python scripts/kernel_turns.py --only ownership --trees OLD NEW NEW OLD
    python scripts/kernel_turns.py --only codes sib --trees OLD NEW NEW OLD
    python scripts/kernel_turns.py --only cycle --trees OLD NEW NEW OLD

--only sf, streams, clip, hist, lookup, owner, cut, ownership, codes, sib
and/or cycle times K6's rows, K15's, K18's and K19's, K16's, K21's, K25's,
K20's, K26's and K27's, K24's (with K1 beside it), K22's, K23's and K28's
(with K7 beside them, and the flagship step) and/or K13's cycle cut's and
K29's (with K6's rows beside them) alone and builds only their
inputs (about 1.5 minutes, then under half
a minute a tree).  K13's cycle cut ("cycle_ptr", "cycle_noptr") on the
links of chip_smoke.py's cycle input (_cycle_spectrum at k = 24,
canonical: 1,572,864 node lanes, built once on the card by this
checkout's K11 and K12), with the label stage's pointers as
build_contig_arrays gives them and without (a tree whose cycle_fix takes
no pointers runs its one-argument call in both rows), with "cycle_sizes"
(C2, cycle lanes, the rounds the reference's loop runs); K29
("jobs_4096", "jobs_65536") on the 5 seeded restart rows of each of
_sf_jobs(7, 4096)'s and _sf_jobs(8, 65_536)'s jobs (restart_rows), with
K6's three rows beside them.  K24 ("codes_*") on chip_smoke.py's kernel-phase reads as
uint8 codes (_random_batch(1, False) and (1, True), 65,536 x 128, k = 24,
canonical: "codes_smoke", "codes_smoke_n") and at 101 codes a row
(_random_batch(2, True, pad=101), k = 31: "codes_101"), and on the dry
run's batch (dryrun_multichip(8): example_batch's 2,048 reads of 100
codes, k = 24), whole as its one-device count takes it ("codes_dryrun")
and as its 8 shard views of 256 rows, one call each, as the sharded count
takes them ("codes_shards", the 8 calls a row); K1 on the kernel-phase
reads packed, unmasked and masked ("extract_smoke", "extract_smoke_masked",
the windows K24 gives from their codes).  K22 ("sib_flagship") on the
flagship table (the lookup group's) and on the counted, shrunk spectrum of
the 1,000,000-read scale dataset (the hist group's, 10,689,722 real lanes:
"sib_counted"), and on the dry run's table (dryrun_multichip(8)'s batch
counted into 2^15 lanes, then abundance_filter(1): "sib_dryrun", the
table of both of its K22 calls), k = 24, canonical; beside it K7 (probe_resolve, "sib")
on the flagship table's real lanes alone ("probe_flagship_real": the same
8 probes a real lane, resolved by K7's group walk and job queue) and K7
on the counted spectrum ("probe_sib", "probe_ext"), which share K22's
probe-group steps.  The sibling-prune round (sibling_prune_round at the
step's ratio 0.1: K22, then K23) on the flagship table ("prune_flagship")
and on the dry run's table ("prune_dryrun"); K28 (neighbor_counts) on the
counted spectrum ("nbr_counted"); and the whole flagship step
(shannon_tpu_torch.entry's step on its own batch, "step_flagship").  K26 ("ownership_pack_2", "ownership_pack_4") packs the
evidence of one assemble of the 1,000,000-read scale dataset on the card in
one process (recorded by wrapping pipeline._assemble_backhalf) for H = 2 and
4 ranks, with owner = comp[0] mod H as _assemble_backhalf makes it, at its
own widest bucket; K27 ("ownership_unpack_2", "_4") unpacks that send
buffer.  "ownership_sizes" gives each H's paths, node ids, cap and real
words (2H + the rows' 2 n_p + n_f); every focus row's "<row>_syncs" counts
the synchronizing calls of one call (torch's sync debug mode), the host
reads of a wrapper that reads with .cpu() or a stream's synchronize as
well as with .item().
K25 ("owner_buckets") runs at chip_smoke.py's owner_row shape: shard 0's
local table of the 1,000,000-read scale dataset's first batch (its first
1/8 of the default batch's rows, k = 24, canonical, counted into the
default 2^22 lanes), bucketed for 8 owners at the default bucket_cap
(2^20), with "owner_sizes".  K1, K24, K7 and K22 rows give "codes_sizes"
and "sib_sizes".  K20's cut mode ("cut_main") runs on the hist
group's spectrum at its auto cut, and the abundance filter
("filter_flagship") on the flagship step's table before its filter (the
lookup group's count, sliced to 2^21 lanes), at cut 1, beside K10 alone
on that table and the filter's keep flags ("compact_flagship").  K16 ("hist_1024",
"hist_65536") runs on the counted, shrunk spectrum of the
1,000,000-read scale dataset at the default AssemblyConfig (12,582,912
lanes, 10,689,722 real) at max_count 1,024 (the auto cut's) and 65,536;
K21 on the flagship table (chip_smoke.py's entry phase: the flagship
step's count of shannon_tpu_torch.entry's batch, sliced to 2^21 lanes
and abundance_filter(1), 174,607 real lanes), queried with the 8 x C
sibling probes of every lane ("lookup_flagship") and with those of its
real lanes alone ("lookup_real"), each beside torch.searchsorted on the
same table and queries ("searchsorted_flagship", "searchsorted_real").

Each tree runs in a fresh process that imports that tree's
shannon_tpu_torch and builds its kernels into that tree's build/ (a tree is
a checkout, e.g. a parent unpacked with git archive into a git-ignored
directory).  Inputs, made once from seeds on the host with the plain
versions: K6 on chip_smoke.py's 4,096 random jobs (_sf_jobs(7, 4096)) at
sf_restarts = 4 ("sf_greedy"), on 65,536 such jobs ("sf_greedy_65536"),
where the kernel dominates, and on the main path's own jobs ("sf_main"):
the buffers of every batched_greedy_packed call of one assemble of the
1,000,000-read scale dataset (recorded once by wrapping the module function
that solve_nodes_device calls, with this checkout's kernels), replayed in
order, a replay a call of the row, with each call's job count
("sf_main_jobs"); K15 ("base_streams") on the ContigArrays each tree's K14
makes of the corrected 1M-read spectrum's labels (the K14 row's inputs).
K18 ("drop_contigs") and K19 ("clip_remap") on the arguments that one
clip of that corrected spectrum at the default AssemblyConfig gives
_drop_contigs and _device_clip_remap (captured by wrapping the two module
functions while this checkout's clip_tips_graph runs, as chip_smoke.py's
_clip_rows does; the node table's four fields and the maps are saved, the
contig arrays' other fields, which neither reads, are left empty).  Each
K6, K15, K18 and K19 row has its device_us, idle_us, "<row>_peak_mib",
"<row>_launch_us", "<row>_launches" (the kernel library's launch counts
of one call), "<row>_host_read_us" (the host's time a call in
aten::_local_scalar_dense, the wait of its reads of the card, from a
torch.profiler trace; with their number, "<row>_host_reads") and
"<row>_sha" (a SHA-256 prefix of every output field and count, equal in
every tree).  K10 at
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
its device_us.  K5 (compact_thread_outputs) on K4's rows of that first
batch; K11 (nodes_stage) on the 1M-read spectrum after correct_spectrum
and shrink_spectrum (3,653,479 k-mers in 4,194,304 lanes, chip_smoke.py's
condensation input), K12 (links_stage) on its node table (8,388,608
lanes) and K13's label stage (label_stage) on those links, each with its
device_us and the card's idle time a call ("idle_us": the event time less
the device time).  The three stages also list every launch of one call
("<stage>_launch_us": the gaps between launches are the idle time); K11
and K12 give a SHA-256 prefix of their outputs (equal in every tree) and
the MiB a call allocates above what it was given ("<stage>_peak_mib");
the label stage gives, where the tree's label_stage reports them, the
rounds run and each round's frontier ("label_stage_info").  K14
("reduce_stage") on those labels (the node table of 8,388,608 lanes and
its links, built once by this checkout's K11-K13); K9 on the counted
spectrum's sibling tables from the counts the main path's rescue (K8's
k + 2 rounds) leaves: "prune_1" one prune_round call, "prune_loop" the
main path's loop at the default AssemblyConfig (prune_rounds where the
tree has it, else its correct_spectrum's loop of prune_round calls with a
host read of the changed flag a round).  Each of the three has its
device_us, idle_us, "<row>_peak_mib", "<row>_launch_us" (K14 and the loop)
and a SHA-256 prefix of its outputs ("<row>_sha", equal in every tree).
Prints one JSON line per tree and, with --out, writes them all.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _counted_spectrum(reads, cfg, dev):
    """The counted, shrunk spectrum of `reads` at `cfg`, on the card."""
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import count_reads_spectrum, shrink_spectrum

    return shrink_spectrum(count_reads_spectrum(
        pack_reads(reads, pad_length=cfg.read_pad_length), k=cfg.k, capacity=cfg.kmer_capacity,
        canonical=not cfg.strand_specific, batch_reads=cfg.batch_reads, device=dev,
    ))


def _condense_inputs(spec, cfg) -> dict:
    """K11-K15's inputs (tensors on the card): the corrected, shrunk
    spectrum of the counted `spec`, its node table (K11), links (K12) and
    labels (K13; no cycle on this spectrum), as chip_smoke.py's
    condensation phase gets them.  K14 turns the labels into the
    ContigArrays that K15 reads."""
    from shannon_tpu_torch.ops.count import shrink_spectrum
    from shannon_tpu_torch.ops.condense import label_stage, links_stage, nodes_stage
    from shannon_tpu_torch.ops.correction import auto_min_abundance, correct_spectrum

    k, canonical = cfg.k, not cfg.strand_specific
    corrected = shrink_spectrum(correct_spectrum(
        spec, k, auto_min_abundance(spec), cfg.sibling_ratio, cfg.correction_rounds, canonical,
        cfg.error_rate,
    ))
    cn_key, cn_count, cn_n = nodes_stage(corrected, k, canonical)
    prev_link, rec_lane, first_p, p_cnt = links_stage(cn_key, k)
    l_ptr, l_dist, _ = label_stage(prev_link)
    return {"k_key": corrected.key, "k_count": corrected.count, "k_n": corrected.n,
            "cn_key": cn_key, "cn_count": cn_count, "cn_n": cn_n, "prev_link": prev_link,
            "rec_lane": rec_lane, "first_p": first_p, "p_cnt": p_cnt, "l_ptr": l_ptr,
            "l_dist": l_dist, "k": k}


def _clip_inputs(condense: dict, cfg) -> dict:
    """K18's and K19's inputs (numpy): the arguments one clip of the
    corrected spectrum (condense's k_key, k_count, k_n) at `cfg` gives
    _drop_contigs and _device_clip_remap, recorded by wrapping both module
    functions while clip_tips_graph runs on the card: the spectrum, the node
    table's four fields, the doom flags, the remap's maps, n_new and
    out_cap."""
    from shannon_tpu_torch.ops import tipclip
    from shannon_tpu_torch.ops.count import Spectrum

    spec = Spectrum(key=condense["k_key"], count=condense["k_count"], n=condense["k_n"])
    calls, drop, remap = {}, tipclip._drop_contigs, tipclip._device_clip_remap

    def recorded(name, fn):
        def wrapped(*args):
            calls[name] = args
            return fn(*args)
        return wrapped

    tipclip._drop_contigs = recorded("drop", drop)
    tipclip._device_clip_remap = recorded("remap", remap)
    try:
        tipclip.clip_tips_graph(spec, cfg, not cfg.strand_specific)
    finally:
        tipclip._drop_contigs, tipclip._device_clip_remap = drop, remap
    if set(calls) != {"drop", "remap"}:
        raise RuntimeError(f"the clip made only {sorted(calls)} of the drop and the remap")
    sp, ca, doomed = calls["drop"]
    _ca, *maps, n_new, out_cap = calls["remap"]
    names = ("new_cid", "off_shift", "hlane", "tlane", "klen", "csum", "rc", "out_e")
    out = {"clip_key": sp.key, "clip_count": sp.count, "clip_n": sp.n, "clip_doomed": doomed,
           "clip_n_nodes": ca.n_nodes, "clip_n_contigs": ca.n_contigs, "clip_n_new": n_new,
           "clip_out_cap": out_cap,
           **{f"clip_{f}": getattr(ca, f) for f in ("node_key", "node_count", "node_cid",
                                                    "node_off")},
           **{f"clip_{n}": m for n, m in zip(names, maps)}}
    return {n: x.cpu().numpy() if hasattr(x, "cpu") else x for n, x in out.items()}


def _sf_main_inputs(reads, cfg, dev) -> dict:
    """K6's main-path inputs (numpy): the buffers of every
    batched_greedy_packed call of one assemble of `reads` on the card,
    recorded by wrapping the module function that solve_nodes_device
    calls; their jobs laid end to end, the job count, k_restarts and
    max_steps of each call."""
    import numpy as np

    from shannon_tpu_torch.ops import sparseflow as tsf
    from shannon_tpu_torch.pipeline import assemble

    calls, solve = [], tsf.batched_greedy_packed

    def recorded(buf, k_restarts, max_steps=2 * tsf.MAXD):
        calls.append((buf.cpu().numpy(), k_restarts, max_steps))
        return solve(buf, k_restarts, max_steps)

    tsf.batched_greedy_packed = recorded
    try:
        assemble(reads, cfg, device=dev)
    finally:
        tsf.batched_greedy_packed = solve
    if not calls:
        raise RuntimeError("the assembly made no batched_greedy_packed call")
    return {"sf_main_buf": np.concatenate([c[0] for c in calls]),
            "sf_main_jobs": np.array([c[0].shape[0] for c in calls]),
            "sf_main_restarts": np.array([c[1] for c in calls]),
            "sf_main_steps": np.array([c[2] for c in calls])}


def _search_inputs(reads) -> dict:
    """K7's, K3's and K11-K15's, K18's and K19's inputs (numpy), built on
    the card."""
    import torch

    from chip_smoke import BATCH_READS, KERNEL_K, KERNEL_PAD, _random_batch
    from chip_smoke import window_keys
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import reduce_sorted
    from shannon_tpu_torch.ops.count import upload_words
    from shannon_tpu_torch.ops.correction import auto_min_abundance
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.ops.spectrum import lookup_sorted
    from shannon_tpu_torch.pipeline import spectrum_device

    dev, cfg = torch.device("cuda", 0), AssemblyConfig()
    spec = _counted_spectrum(reads, cfg, dev)
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
    condense = _condense_inputs(spec, cfg)
    out = {"p_key": spec.key, "p_count": spec.count, "node_key": ca.node_key,
           "windows": windows, "r_table": r_table, "r_query": r_query, "t_idx": t_idx,
           "t_hit": t_hit, "t_valid": valid, "node_cid": ca.node_cid, "node_off": ca.node_off,
           **condense, **_clip_inputs(condense, cfg)}
    out = {name: x.cpu().numpy() if torch.is_tensor(x) else x for name, x in out.items()}
    out["cut"] = auto_min_abundance(spec)
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


def _lookup_inputs(dev) -> dict:
    """K21's table (numpy): chip_smoke.py's entry phase's, the flagship
    step's count of shannon_tpu_torch.entry's batch sliced to
    CORRECT_CAP lanes, then abundance_filter(MIN_ABUNDANCE)."""
    from shannon_tpu_torch import entry as tentry
    from shannon_tpu_torch.ops.correction import abundance_filter
    from shannon_tpu_torch.ops.count import _slice_spectrum, count_spectrum_packed

    _step, (words, lengths) = tentry.entry(device=dev)
    spec = _slice_spectrum(count_spectrum_packed(words, lengths, k=tentry.K,
                                                 capacity=tentry.CAPACITY,
                                                 length=tentry.READ_LEN), tentry.CORRECT_CAP)
    table = abundance_filter(spec, tentry.MIN_ABUNDANCE)
    return {"l_key": table.key.cpu().numpy(), "l_count": table.count.cpu().numpy(),
            "l_n": table.n, "l_k": tentry.K, "f_key": spec.key.cpu().numpy(),
            "f_count": spec.count.cpu().numpy(), "f_n": spec.n, "f_cut": tentry.MIN_ABUNDANCE}


def _owner_inputs(reads, cfg, dev) -> dict:
    """K25's input (numpy): chip_smoke.py's owner_row table, shard 0's local
    spectrum of the first read batch, with its owners and bucket_cap."""
    import torch

    from chip_smoke import SHARDS
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import count_window_keys, upload_words
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.parallel.distributed import default_bucket_cap

    rows = cfg.batch_reads // SHARDS
    batch = pack_reads(reads[:rows], pad_length=cfg.read_pad_length)
    m = batch.mask_rows(0, rows)
    keys, _ = extract_kmers_packed(
        upload_words(batch.words, dev), torch.from_numpy(batch.lengths).to(dev), cfg.k, True,
        batch.pad_length, None if m is None else upload_words(m, dev))
    local = count_window_keys(keys, cfg.kmer_capacity)
    return {"o_key": local.key.cpu().numpy(), "o_count": local.count.cpu().numpy(),
            "o_n": local.n, "o_dev": SHARDS,
            "o_cap": default_bucket_cap(cfg.kmer_capacity, SHARDS)}


# Ranks K26 and K27 are timed at ("ownership_pack_<H>", "ownership_unpack_<H>").
OWNERSHIP_RANKS = (2, 4)


def _codes_inputs() -> dict:
    """K24's and K1's inputs (numpy): chip_smoke.py's kernel-phase reads,
    packed and as codes, without and with N codes, at 101 codes a row, and
    dryrun_multichip(8)'s batch as codes."""
    import torch

    from chip_smoke import SHARDS, _random_batch
    from shannon_tpu_torch import entry as tentry

    cpu, out = torch.device("cpu"), {}
    for name, (seed, with_n, pad) in (("smoke", (1, False, 128)), ("smoke_n", (1, True, 128)),
                                      ("101", (2, True, 101))):
        words, lengths, mask, codes = _random_batch(seed, with_n, cpu, codes_too=True, pad=pad)
        out.update({f"x{name}_words": words.numpy(), f"x{name}_lengths": lengths.numpy(),
                    f"x{name}_codes": codes.numpy()})
        if mask is not None:
            out[f"x{name}_mask"] = mask.numpy()
    batch = tentry.example_batch(256 * SHARDS, tentry.READ_LEN)
    out.update(xdry_codes=batch.codes, xdry_lengths=batch.lengths, xdry_shards=SHARDS,
               xdry_k=tentry.K)
    return out


def _sib_dryrun_inputs() -> dict:
    """K22's input in dryrun_multichip(8), made with the plain versions:
    its batch counted into 2^15 lanes (count_spectrum, as its one-device
    count; the sharded count gives the same table), then
    abundance_filter(1)."""
    import torch

    from chip_smoke import SHARDS
    from shannon_tpu_torch import entry as tentry
    from shannon_tpu_torch.ops.correction import abundance_filter
    from shannon_tpu_torch.ops.count import count_spectrum

    batch = tentry.example_batch(256 * SHARDS, tentry.READ_LEN)
    spec = count_spectrum(torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths),
                          tentry.K, 1 << 15)
    spec = abundance_filter(spec, tentry.MIN_ABUNDANCE)
    return {"d_key": spec.key.numpy(), "d_count": spec.count.numpy(), "d_n": spec.n,
            "d_k": tentry.K}


def _ownership_inputs(reads, cfg, dev) -> dict:
    """K26's inputs (numpy): the evidence (flat, offs, weights) and the
    component owners of one assemble of `reads` on the card in one process,
    recorded by wrapping pipeline._assemble_backhalf; owner = comp[0] mod H
    for each H of OWNERSHIP_RANKS, as _assemble_backhalf makes it in a
    group of H ranks."""
    import numpy as np

    from shannon_tpu_torch import pipeline

    seen, backhalf = {}, pipeline._assemble_backhalf

    def recorded(cgraph, comps, evidence, *rest):
        seen.update(n=cgraph.n, comps=comps, evidence=evidence)
        return backhalf(cgraph, comps, evidence, *rest)

    pipeline._assemble_backhalf = recorded
    try:
        pipeline.assemble(reads, cfg, device=dev)
    finally:
        pipeline._assemble_backhalf = backhalf
    flat, offs, weights = (np.asarray(a, np.int64) for a in seen["evidence"])
    out = {"w_flat": flat, "w_offs": offs, "w_weights": weights}
    for H in OWNERSHIP_RANKS:
        owner = np.zeros(seen["n"], np.int64)
        for comp in seen["comps"]:
            owner[comp] = comp[0] % H
        out[f"w_owner{H}"] = owner
    return out


def _cycle_inputs(dev) -> dict:
    """K13's cycle cut's inputs (numpy): the links of chip_smoke.py's cycle
    input (_cycle_spectrum at k = 24, canonical) and the label stage's
    pointers on them, made on the card by this checkout's K11-K13."""
    from chip_smoke import _cycle_spectrum
    from shannon_tpu_torch.ops.condense import label_stage, links_stage, nodes_stage

    node_key = nodes_stage(_cycle_spectrum(dev, 24), 24, True)[0]
    prev = links_stage(node_key, 24)[0]
    ptr, _dist, has_cycle = label_stage(prev)
    if not has_cycle:
        raise RuntimeError("the cycle input's labels found no cycle")
    return {"cyc_prev": prev.cpu().numpy(), "cyc_ptr": ptr.cpu().numpy()}


def _inputs(path: Path, only) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from chip_smoke import _scale_dataset, _sf_jobs, window_keys
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.ops.count import reduce_sorted_plain

    dev, cfg = torch.device("cuda", 0), AssemblyConfig()
    focus = {"buf": _sf_jobs(7, 4096), "big": _sf_jobs(8, 65_536)}
    if only is not None and "cycle" in only:
        focus.update(_cycle_inputs(dev))
    if only is not None and "codes" in only:
        focus.update(_codes_inputs())
    if only is not None and "sib" in only:
        focus.update(_sib_dryrun_inputs())
    if only is not None and not {"sf", "streams", "clip", "hist", "owner", "cut",
                                 "ownership", "sib", "cycle"} & set(only):
        if "lookup" in only:
            focus.update(_lookup_inputs(dev))
        np.savez(path, **focus)
        return
    reads = _scale_dataset(1_000_000)[1]
    if only is None or "sf" in only or "cycle" in only:
        focus.update(_sf_main_inputs(reads, cfg, dev))
    if only is not None:
        if "streams" in only or "clip" in only:
            condense = _condense_inputs(_counted_spectrum(reads, cfg, dev), cfg)
            focus.update({n: x.cpu().numpy() if torch.is_tensor(x) else x
                          for n, x in condense.items()})
        if "clip" in only:
            focus.update(_clip_inputs(condense, cfg))
        if "hist" in only or "cut" in only or "sib" in only:
            spec = _counted_spectrum(reads, cfg, dev)
            focus.update(h_key=spec.key.cpu().numpy(), h_count=spec.count.cpu().numpy(),
                         h_n=spec.n)
            del spec
        if "lookup" in only or "cut" in only or "sib" in only:
            focus.update(_lookup_inputs(dev))
        if "owner" in only:
            focus.update(_owner_inputs(reads, cfg, dev))
        if "ownership" in only:
            focus.update(_ownership_inputs(reads, cfg, dev))
        np.savez(path, **focus)
        return

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
    bkeys = window_keys(cpu, reads=reads)
    np.savez(path, **focus, c_key=c_key, c_count=c_count, c_keep=c_keep, unit=unit.numpy(),
             mkeys=mkeys.numpy(), mcounts=mcounts.numpy(),
             bkeys=bkeys.numpy(), **_search_inputs(reads))


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


def _peak_mib(fn) -> float:
    """MiB a call of fn allocates on the card above what was held before it
    (torch.cuda.max_memory_allocated after reset_peak_memory_stats)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _median_ms(fn, reps: int = 200, windows: int = 5) -> float:
    """The median over `windows` of CUDA-event ms a call, `reps` calls a
    window, after a warm-up."""
    import torch

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


def _digest(tensors) -> str:
    """SHA-256 prefix of a call's outputs, so the trees' rows show they are
    equal."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _tensors(out) -> list:
    """A call's outputs as tensors: the fields of a dataclass (a Spectrum,
    ContigArrays) or the items of a sequence (an output not asked for,
    None, left out), each count as a tensor too."""
    import dataclasses

    import torch

    if torch.is_tensor(out):
        return [out]
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    return [x if torch.is_tensor(x) else torch.tensor([x]) for x in out if x is not None]


def _host_reads(fn, calls: int = 20) -> tuple[float, float]:
    """(host us a call in aten::_local_scalar_dense, reads a call): the
    waits of fn's reads of the card, from a torch.profiler trace of `calls`
    calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for evt in prof.key_averages():
        if evt.key == "aten::_local_scalar_dense":
            us += evt.cpu_time_total
            n += evt.count
    return us / calls, n / calls


def _syncs(fn) -> int:
    """The synchronizing calls (host reads of the card) of one call of fn,
    as torch's sync debug mode warns of them, after a warm-up."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def _launches(fn) -> dict:
    """The kernel library's launch counts of one call of fn."""
    from shannon_tpu_torch import kernels

    lib = kernels.library()
    before = dict(lib.launches)
    fn()
    return {k: v - before[k] for k, v in lib.launches.items() if v != before[k]}


def _focus_rows(d, dev, only) -> dict:
    """K6's rows ("sf_greedy": 4,096 random jobs; "sf_greedy_65536";
    "sf_main": every call the 1M-read single-end assembly made, replayed in
    order, a replay a call of the row), K15's ("base_streams", on the
    ContigArrays that this tree's K14 makes of the saved labels), K18's
    ("drop_contigs") and K19's ("clip_remap", both on one clip's saved
    arguments): each with ms, device_us, idle_us, MiB a call above its
    inputs, its launches, its host reads and a SHA-256 prefix of its
    outputs; "<row>_launch_us" lists one call's launches."""
    import torch

    from shannon_tpu_torch.ops.sparseflow import batched_greedy_packed

    fns = {}
    if only is None or "sf" in only or "cycle" in only:
        buf, big = (torch.from_numpy(d[x]).to(dev) for x in ("buf", "big"))
        jobs = d["sf_main_jobs"].tolist()
        bufs = torch.from_numpy(d["sf_main_buf"]).to(dev).split(jobs)
        main = list(zip(bufs, d["sf_main_restarts"].tolist(), d["sf_main_steps"].tolist()))

        def sf_main():
            out = []
            for b, r, steps in main:
                out.extend(batched_greedy_packed(b, r, steps))
            return out

        fns.update(sf_greedy=(lambda: batched_greedy_packed(buf, 4), 200),
                   sf_greedy_65536=(lambda: batched_greedy_packed(big, 4), 200),
                   sf_main=(sf_main, 50))
    if only is not None and "cycle" in only:
        import inspect

        import numpy as np

        from shannon_tpu_torch.ops.condense import cycle_fix
        from shannon_tpu_torch.ops.sparseflow import batched_greedy, restart_rows

        c_prev, c_ptr = (torch.from_numpy(d[x]).to(dev) for x in ("cyc_prev", "cyc_ptr"))
        takes_ptr = "head_ptr" in inspect.signature(cycle_fix).parameters
        rows_4096, rows_65536 = restart_rows(buf, 4), restart_rows(big, 4)
        fns.update(
            cycle_ptr=((lambda: cycle_fix(c_prev, c_ptr)) if takes_ptr
                       else (lambda: cycle_fix(c_prev)), 50),
            cycle_noptr=(lambda: cycle_fix(c_prev), 50),
            jobs_4096=(lambda: batched_greedy(*rows_4096), 200),
            jobs_65536=(lambda: batched_greedy(*rows_65536), 50))
        # the cycle lanes and the rounds the reference's loop would need
        # before no minimum changes on them, from the saved arrays
        p_np, h_np = d["cyc_prev"], d["cyc_ptr"]
        in_s = p_np[h_np] >= 0
        cycle_sizes = {"C2": int(p_np.shape[0]), "cycle_lanes": int(in_s.sum()),
                       "takes_ptr": takes_ptr}
        ptr_np, mn = np.where(p_np >= 0, p_np, np.arange(p_np.shape[0])), np.arange(p_np.shape[0])
        for r in range(1, max(p_np.shape[0].bit_length(), 1) + 1):
            nxt = np.minimum(mn, mn[ptr_np])
            if (nxt[in_s] == mn[in_s]).all():
                break
            ptr_np, mn = ptr_np[ptr_np], nxt
        cycle_sizes["rounds"] = r
    if only is None or "streams" in only:
        from shannon_tpu_torch.ops.condense import contig_base_streams, reduce_stage

        k = int(d["k"])
        ca = reduce_stage(*(torch.from_numpy(d[x]).to(dev) for x in (
            "cn_key", "cn_count")), int(d["cn_n"]), *(torch.from_numpy(d[x]).to(dev) for x in (
                "prev_link", "l_ptr", "l_dist", "rec_lane", "first_p", "p_cnt")), k, True)
        fns["base_streams"] = (lambda: contig_base_streams(ca, k), 200)
    if only is None or "clip" in only:
        from shannon_tpu_torch.ops import tipclip
        from shannon_tpu_torch.ops.condense import ContigArrays
        from shannon_tpu_torch.ops.count import Spectrum

        def on_card(name: str) -> torch.Tensor:
            return torch.from_numpy(d[f"clip_{name}"]).to(dev)

        clip_spec = Spectrum(key=on_card("key"), count=on_card("count"), n=int(d["clip_n"]))
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        clip_ca = ContigArrays(
            **{f: on_card(f) for f in ("node_key", "node_count", "node_cid", "node_off")},
            klen=empty, abundance=empty.float(), count_sum=empty, head_lane=empty,
            tail_lane=empty, out_edges=empty.view(4, 0), rc_pair=empty,
            n_nodes=int(d["clip_n_nodes"]), n_contigs=int(d["clip_n_contigs"]))
        doomed = on_card("doomed")
        maps = [on_card(x) for x in ("new_cid", "off_shift", "hlane", "tlane", "klen", "csum",
                                     "rc", "out_e")]
        remap_args = (clip_ca, *maps, int(d["clip_n_new"]), int(d["clip_out_cap"]))
        fns["drop_contigs"] = (lambda: tipclip._drop_contigs(clip_spec, clip_ca, doomed), 200)
        fns["clip_remap"] = (lambda: tipclip._device_clip_remap(*remap_args), 200)
        drop_n = tipclip._drop_contigs(clip_spec, clip_ca, doomed).n
        remap_n = tipclip._device_clip_remap(*remap_args).n_nodes
    if only is not None and "hist" in only:
        from shannon_tpu_torch.ops.correction import count_histogram
        from shannon_tpu_torch.ops.count import Spectrum

        h_spec = Spectrum(key=torch.from_numpy(d["h_key"]).to(dev),
                          count=torch.from_numpy(d["h_count"]).to(dev), n=int(d["h_n"]))
        fns["hist_1024"] = (lambda: count_histogram(h_spec, 1024), 200)
        fns["hist_65536"] = (lambda: count_histogram(h_spec, 65_536), 200)
    if only is not None and "lookup" in only:
        from shannon_tpu_torch.ops.count import Spectrum
        from shannon_tpu_torch.ops.spectrum import lookup_counts, probe_keys

        table = Spectrum(key=torch.from_numpy(d["l_key"]).to(dev),
                         count=torch.from_numpy(d["l_count"]).to(dev), n=int(d["l_n"]))
        n_tab, lk = min(table.n, table.capacity), int(d["l_k"])
        q_all = probe_keys(table.key, lk, "sib", True)
        q_real = probe_keys(table.key[:n_tab], lk, "sib", True)
        fns.update(lookup_flagship=(lambda: lookup_counts(table, q_all), 200),
                   lookup_real=(lambda: lookup_counts(table, q_real), 200),
                   searchsorted_flagship=(lambda: torch.searchsorted(table.key, q_all), 200),
                   searchsorted_real=(lambda: torch.searchsorted(table.key, q_real), 200))
    if only is not None and "owner" in only:
        import inspect

        from shannon_tpu_torch.parallel import distributed as td

        o_key, o_count = (torch.from_numpy(d[x]).to(dev) for x in ("o_key", "o_count"))
        o_real, o_dev, o_cap = min(int(d["o_n"]), o_key.shape[0]), int(d["o_dev"]), int(d["o_cap"])
        if "n_real" in inspect.signature(td.owner_buckets).parameters:
            fns["owner_buckets"] = (
                lambda: td.owner_buckets(o_key, o_count, o_dev, o_cap, o_real), 200)
        else:  # a tree before K25 took n_real
            fns["owner_buckets"] = (lambda: td.owner_buckets(o_key, o_count, o_dev, o_cap), 200)
    if only is not None and "ownership" in only:
        import numpy as np

        from shannon_tpu_torch.parallel import multihost as tmh

        w_ev = [torch.from_numpy(d[x].astype(np.int32)).to(dev)
                for x in ("w_flat", "w_offs", "w_weights")]
        w_sizes = {}
        for H in OWNERSHIP_RANKS:
            w_args = (*w_ev, torch.from_numpy(d[f"w_owner{H}"].astype(np.int32)).to(dev), H)
            w_send = tmh.ownership_pack(*w_args)[0]
            fns[f"ownership_pack_{H}"] = (lambda a=w_args: tmh.ownership_pack(*a), 200)
            fns[f"ownership_unpack_{H}"] = (lambda r=w_send: tmh.ownership_unpack(r), 200)
            w_sizes[H] = {"paths": w_ev[1].shape[0] - 1, "ids": w_ev[0].shape[0], "H": H,
                          "cap": w_send.shape[1],
                          "real_words": int(2 * H + 2 * w_send[:, 0].sum() + w_send[:, 1].sum())}
    if only is not None and "cut" in only:
        from shannon_tpu_torch.ops import correction as tcor
        from shannon_tpu_torch.ops.count import Spectrum

        def spectrum(p: str) -> Spectrum:
            return Spectrum(key=torch.from_numpy(d[f"{p}_key"]).to(dev),
                            count=torch.from_numpy(d[f"{p}_count"]).to(dev), n=int(d[f"{p}_n"]))

        c_spec, f_spec, f_cut = spectrum("h"), spectrum("f"), int(d["f_cut"])
        c_cut = tcor.auto_min_abundance(c_spec)
        f_keep = tcor.abundance_cut_plain(f_spec, f_cut, False, False)[2]
        fns.update(
            cut_main=(lambda: tcor.cut_counts(c_spec, c_cut), 200),
            filter_flagship=(lambda: tcor.abundance_filter(f_spec, f_cut), 200),
            compact_flagship=(lambda: tcor.compact(f_spec, f_keep), 200))
    if only is not None and "codes" in only:
        from shannon_tpu_torch.ops.kmers import extract_kmers, extract_kmers_packed

        def x(name: str) -> torch.Tensor:
            return torch.from_numpy(d[name]).to(dev)

        xs = {name: (x(f"x{name}_codes"), x(f"x{name}_lengths"), x(f"x{name}_words"))
              for name in ("smoke", "smoke_n", "101")}
        x_mask = x("xsmoke_n_mask")
        dry_codes, dry_lengths = x("xdry_codes"), x("xdry_lengths")
        shards, dry_k = int(d["xdry_shards"]), int(d["xdry_k"])
        rows = dry_codes.shape[0] // shards
        shard_views = [(dry_codes[i * rows:(i + 1) * rows], dry_lengths[i * rows:(i + 1) * rows])
                       for i in range(shards)]

        def codes_shards():
            return [t for c, n in shard_views for t in extract_kmers(c, n, dry_k, True)]

        fns.update(
            codes_smoke=(lambda: extract_kmers(*xs["smoke"][:2], 24, True), 200),
            codes_smoke_n=(lambda: extract_kmers(*xs["smoke_n"][:2], 24, True), 200),
            codes_101=(lambda: extract_kmers(*xs["101"][:2], 31, True), 200),
            codes_dryrun=(lambda: extract_kmers(dry_codes, dry_lengths, dry_k, True), 200),
            codes_shards=(codes_shards, 200),
            extract_smoke=(lambda: extract_kmers_packed(
                xs["smoke"][2], xs["smoke"][1], 24, True, 128, None), 200),
            extract_smoke_masked=(lambda: extract_kmers_packed(
                xs["smoke_n"][2], xs["smoke_n"][1], 24, True, 128, x_mask), 200))
        codes_sizes = {name: list(c.shape) for name, (c, _n, _w) in xs.items()}
        codes_sizes.update(dryrun=list(dry_codes.shape), shards=shards)
    if only is not None and "sib" in only:
        from shannon_tpu_torch import entry as tentry
        from shannon_tpu_torch.ops.correction import probe_resolve, sibling_prune_round
        from shannon_tpu_torch.ops.count import Spectrum
        from shannon_tpu_torch.ops.spectrum import neighbor_counts, sibling_maxes

        def card_spectrum(p: str) -> Spectrum:
            return Spectrum(key=torch.from_numpy(d[f"{p}_key"]).to(dev),
                            count=torch.from_numpy(d[f"{p}_count"]).to(dev), n=int(d[f"{p}_n"]))

        s_flag, s_counted, sk = card_spectrum("l"), card_spectrum("h"), int(d["l_k"])
        s_dry, dk = card_spectrum("d"), int(d["d_k"])
        s_n = min(s_flag.n, s_flag.capacity)
        s_real = Spectrum(key=s_flag.key[:s_n], count=s_flag.count[:s_n], n=s_n)
        fns.update(
            sib_flagship=(lambda: sibling_maxes(s_flag, sk, True), 200),
            sib_counted=(lambda: sibling_maxes(s_counted, 24, True), 50),
            sib_dryrun=(lambda: sibling_maxes(s_dry, dk, True), 200),
            probe_flagship_real=(lambda: probe_resolve(s_real, sk, True, "sib"), 200),
            probe_sib=(lambda: probe_resolve(s_counted, 24, True, "sib"), 20),
            probe_ext=(lambda: probe_resolve(s_counted, 24, True, "ext"), 20))
        ratio = tentry.SIBLING_RATIO
        step, step_args = tentry.entry(device=dev)
        fns.update(
            prune_flagship=(lambda: sibling_prune_round(s_flag, sk, ratio, True), 200),
            prune_dryrun=(lambda: sibling_prune_round(s_dry, dk, ratio, True), 200),
            nbr_counted=(lambda: neighbor_counts(s_counted, 24, True), 20),
            step_flagship=(lambda: step(*step_args), 50))
        sib_sizes = {"flagship_C": s_flag.capacity, "flagship_n": s_n,
                     "counted_C": s_counted.capacity,
                     "counted_n": min(s_counted.n, s_counted.capacity),
                     "dryrun_C": s_dry.capacity, "dryrun_n": min(s_dry.n, s_dry.capacity)}
    row = {f"{name}_ms": _median_ms(fn, reps) for name, (fn, reps) in fns.items()}
    if "cycle_ptr" in fns:
        row["cycle_sizes"] = cycle_sizes
    if "codes_smoke" in fns:
        row["codes_sizes"] = codes_sizes
    if "sib_flagship" in fns:
        row["sib_sizes"] = sib_sizes
    if "ownership_pack_2" in fns:
        row["ownership_sizes"] = w_sizes
    if "owner_buckets" in fns:
        row["owner_sizes"] = {"C": o_key.shape[0], "n_real": o_real, "D": o_dev, "cap": o_cap}
    if "cut_main" in fns:
        row["cut_sizes"] = {"C": c_spec.capacity, "n_real": min(c_spec.n, c_spec.capacity),
                            "cut": c_cut, "flagship_C": f_spec.capacity,
                            "flagship_n_real": min(f_spec.n, f_spec.capacity),
                            "flagship_cut": f_cut}
    if "lookup_flagship" in fns:
        row["lookup_sizes"] = {"C": table.capacity, "n": n_tab, "flagship": q_all.numel(),
                               "real": q_real.numel()}
    if "sf_main" in fns:
        row["sf_main_jobs"] = jobs
        row["sf_main_ms_per_call"] = row["sf_main_ms"] / len(jobs)
    if "base_streams" in fns:
        row["base_streams_sizes"] = [ca.n_nodes, ca.n_contigs, int(ca.node_key.shape[0])]
    if "clip_remap" in fns:
        row["clip_sizes"] = {"C": int(d["clip_key"].shape[0]), "n": int(d["clip_n"]),
                             "C2": int(d["clip_node_key"].shape[0]),
                             "n_nodes": int(d["clip_n_nodes"]),
                             "doomed": int(d["clip_doomed"].sum()),
                             "dropped_to": drop_n, "kept_nodes": remap_n,
                             "n_new": int(d["clip_n_new"]), "out_cap": int(d["clip_out_cap"])}
    for name, (fn, _reps) in fns.items():
        row[f"{name}_sha"] = _digest(_tensors(fn()))
        row[f"{name}_peak_mib"] = _peak_mib(fn)
        row[f"{name}_launch_us"] = _launch_us(fn)
        row[f"{name}_launches"] = _launches(fn)
        row[f"{name}_host_read_us"], row[f"{name}_host_reads"] = _host_reads(fn)
        row[f"{name}_syncs"] = _syncs(fn)
    # after the timings, so the traces cannot disturb them
    row["device_us"] = {name: _device_us(fn) for name, (fn, _reps) in fns.items()}
    row["idle_us"] = {name: row[f"{name}_ms"] * 1e3 - sum(row["device_us"][name].values())
                      for name in fns}
    return row


def _label_info(label_stage, prev_link) -> dict:
    """The rounds run and each round's frontier of one label_stage call,
    where the tree's label_stage reports them (its info argument)."""
    import inspect

    info = {}
    if "info" in inspect.signature(label_stage).parameters:
        label_stage(prev_link, info=info)
    return info


def _child(tree: str, inputs: str, only) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import shannon_tpu_torch
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.ops import correction as tcor
    from shannon_tpu_torch.ops.correction import compact, probe_resolve
    from shannon_tpu_torch.ops.condense import label_stage, links_stage, nodes_stage
    from shannon_tpu_torch.ops.condense import reduce_stage
    from shannon_tpu_torch.ops.thread import compact_thread_outputs, thread_windows
    from shannon_tpu_torch.ops import count as count_module
    from shannon_tpu_torch.ops.count import Spectrum, merge_at, merge_at_plain, merge_batch
    from shannon_tpu_torch.ops.count import reduce_sorted
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.ops.spectrum import lookup_sorted, probe_keys

    assert Path(shannon_tpu_torch.__file__).resolve().is_relative_to(Path(tree).resolve())
    dev = torch.device("cuda", 0)
    d = np.load(inputs)
    if only is not None:
        print(json.dumps({"tree": tree, **_focus_rows(d, dev, only),
                          "card": torch.cuda.get_device_name(0)}), flush=True)
        return

    def on_card(name: str) -> torch.Tensor:
        return torch.from_numpy(d[name]).to(dev)

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
    # K9 from the main path's rescue: one round, and the main path's loop (a
    # tree without prune_rounds runs its correct_spectrum's loop of
    # prune_round calls, a host read of the changed flag a round)
    cfg = AssemblyConfig()
    ratio, eps3 = tcor.prune_constants(cfg.sibling_ratio, cfg.error_rate)
    use_cap, p_rounds = cfg.error_rate > 0, cfg.correction_rounds
    rescued = rescue(k + 2)

    def prune_1():
        return tcor.prune_round(rescued, *sib, ratio, eps3, use_cap)[0]

    if hasattr(tcor, "prune_rounds"):
        def prune_loop():
            return tcor.prune_rounds(rescued, *sib, ratio, eps3, use_cap, p_rounds)[0]
    else:
        def prune_loop():
            c = rescued
            for _ in range(p_rounds):
                nxt, changed = tcor.prune_round(c, *sib, ratio, eps3, use_cap)
                if not changed:
                    break
                c = nxt
            return c
    # K5 on K4's rows of that batch; K11's node table of the corrected
    # spectrum, K12's links of that table, K13's label stage on them and
    # K14 on those labels
    rows = thread_windows(*threading)
    prev_link = on_card("prev_link")
    corrected = Spectrum(key=on_card("k_key"), count=on_card("k_count"), n=int(d["k_n"]))
    cn_key = on_card("cn_key")
    r_args = (cn_key, on_card("cn_count"), int(d["cn_n"]), prev_link, on_card("l_ptr"),
              on_card("l_dist"), on_card("rec_lane"), on_card("first_p"), on_card("p_cnt"),
              k, True)
    loops = {"thread_rows": (lambda: thread_windows(*threading), 200),
             "rescue_1": (lambda: rescue(1), 200),
             "rescue_loop": (lambda: rescue(k + 2), 20),
             "prune_1": (prune_1, 200),
             "prune_loop": (prune_loop, 200),
             "compact_rows": (lambda: compact_thread_outputs(*rows), 200),
             "nodes_stage": (lambda: nodes_stage(corrected, k, True), 50),
             "links_stage": (lambda: links_stage(cn_key, k), 50),
             "label_stage": (lambda: label_stage(prev_link), 50),
             "reduce_stage": (lambda: reduce_stage(*r_args), 50)}
    staged = ("compact_rows", "nodes_stage", "links_stage", "label_stage", "reduce_stage",
              "prune_1", "prune_loop")
    contig_fields = ("node_cid", "node_off", "klen", "abundance", "count_sum", "head_lane",
                     "tail_lane", "out_edges", "rc_pair")

    search_ms = {}
    for name, (fn, library, reps) in search.items():
        search_ms[f"{name}_ms"] = _median_ms(fn, reps)
        search_ms[f"{name}_searchsorted_ms"] = _median_ms(library, reps)

    row = {
        "tree": tree,
        "compact_keep_ms": _median_ms(lambda: compact(table, keep)),
        "compact_keep_n": compact(table, keep).n,
        "reduce_sorted_unit_ms": _median_ms(lambda: reduce_sorted(unit, None, cap)),
        "reduce_sorted_merge_ms": _median_ms(lambda: reduce_sorted(mkeys, mcounts, cap)),
        "reduce_sorted_batch_ms": _median_ms(lambda: reduce_sorted(bkeys, None, cap)),
        "reduce_sorted_n": [reduce_sorted(x, c, cap)[3]
                            for x, c in ((unit, None), (mkeys, mcounts), (bkeys, None))],
        **search_ms,
        **{f"{name}_ms": _median_ms(fn, reps) for name, (fn, reps) in loops.items()},
        "rescue_loop_rescued": int((rescue(k + 2) != counts).sum()),
        "rescue_loop_launch_us": _launch_us(lambda: rescue(k + 2)),
        "thread_rows_events": int(thread_windows(*threading)[2].sum()),
        "compact_rows_totals": [int(x.shape[0]) for x in compact_thread_outputs(*rows)[:4:2]],
        "label_stage_has_cycle": label_stage(prev_link)[2],
        "label_stage_info": _label_info(label_stage, prev_link),
        "label_stage_launch_us": _launch_us(lambda: label_stage(prev_link)),
        "nodes_stage_n": nodes_stage(corrected, k, True)[2],
        "nodes_stage_sha": _digest(nodes_stage(corrected, k, True)[:2]),
        "links_stage_sha": _digest(links_stage(cn_key, k)),
        "nodes_stage_launch_us": _launch_us(lambda: nodes_stage(corrected, k, True)),
        "links_stage_launch_us": _launch_us(lambda: links_stage(cn_key, k)),
        "nodes_stage_peak_mib": _peak_mib(lambda: nodes_stage(corrected, k, True)),
        "links_stage_peak_mib": _peak_mib(lambda: links_stage(cn_key, k)),
        "reduce_stage_n": reduce_stage(*r_args).n_contigs,
        "reduce_stage_sha": _digest(getattr(reduce_stage(*r_args), f) for f in contig_fields),
        "reduce_stage_launch_us": _launch_us(lambda: reduce_stage(*r_args)),
        "reduce_stage_peak_mib": _peak_mib(lambda: reduce_stage(*r_args)),
        "prune_1_pruned": int((prune_1() != rescued).sum()),
        "prune_loop_pruned": int((prune_loop() != rescued).sum()),
        "prune_1_sha": _digest([prune_1()]),
        "prune_loop_sha": _digest([prune_loop()]),
        "prune_loop_launch_us": _launch_us(prune_loop),
        "prune_1_peak_mib": _peak_mib(prune_1),
        "prune_loop_peak_mib": _peak_mib(prune_loop),
        **{f"{name}_ms": _median_ms(lambda a=args: extract_kmers_packed(*a))
           for name, args in extracts.items()},
        **{f"{name}_ms": _median_ms(lambda a=args: merge_at(*a)) for name, args in merges.items()},
        "merge_replay_ms": _median_ms(replay, 20),
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
            **{name: _device_us(fn, 5 if name in ("rescue_loop", "label_stage", "nodes_stage",
                                                  "links_stage", "reduce_stage") else 20)
               for name, (fn, _reps) in loops.items()},
            **{f"{name}_searchsorted": _device_us(lib) for name, (_fn, lib, _r) in search.items()},
            **{name: _device_us(lambda a=args: extract_kmers_packed(*a))
               for name, args in extracts.items()},
            **{name: _device_us(lambda a=args: merge_at(*a)) for name, args in merges.items()},
            "merge_replay": _device_us(replay, 5),
        },
    }
    # the card's idle time a call: the event time less the device time
    row["idle_us"] = {name: row[f"{name}_ms"] * 1e3 - sum(row["device_us"][name].values())
                      for name in staged}
    focus = _focus_rows(d, dev, None)
    row["device_us"].update(focus.pop("device_us"))
    row["idle_us"].update(focus.pop("idle_us"))
    print(json.dumps({**row, **focus}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="+",
                    choices=("sf", "streams", "clip", "hist", "lookup", "owner", "cut",
                             "ownership", "codes", "sib", "cycle"),
                    default=None,
                    help="time only K6's rows (sf), K15's (streams), K18's and K19's (clip), "
                         "K16's (hist), K21's (lookup), K25's (owner), K20's (cut), K26's "
                         "and K27's (ownership), K24's and K1's (codes), K22's and "
                         "K7's (sib) and/or K13's cycle cut and K29 with K6 (cycle)")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "INPUTS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(*args.child, args.only)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.npz"
        _inputs(inputs, args.only)
        only = ["--only", *args.only] if args.only else []
        for tree in args.trees:
            proc = subprocess.run(
                [sys.executable, __file__, "--trees", tree, *only, "--child", tree, str(inputs)],
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
