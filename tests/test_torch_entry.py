"""Port parity: the flagship count-and-correct step (shannon_tpu_torch.entry)
against __graft_entry__.py's batch and the same composition of the JAX
package on JAX-CPU (count_spectrum_packed, _slice_spectrum,
abundance_filter(1), sibling_prune_round(f32(0.1))), at 512 reads; and
dryrun_multichip against the reference's on 2 and 8 virtual devices.  The
plain versions run here (CPU tensors); chip_smoke.py holds the step on the
card against the flagship's reference figures and its CPU run.

Tolerance: exact — words and lengths equal; corrected keys, counts and n
equal over the whole table."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from shannon_tpu.ops import correction as jcor
from shannon_tpu.ops.count import _slice_spectrum, count_spectrum_packed
from shannon_tpu_torch import convert, entry as tentry
from shannon_tpu_torch.ops.count import Spectrum, upload_words

N_READS = 512
CAPACITY = 1 << 15
CORRECT_CAP = 1 << 14


def test_example_batch_matches_reference():
    want = graft._example_batch(N_READS, tentry.READ_LEN)
    got = tentry.example_batch(N_READS, tentry.READ_LEN)
    assert got.words.dtype == want.words.dtype
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("k", [24, 31])
def test_step_matches_reference(k):
    batch = tentry.example_batch(N_READS, tentry.READ_LEN)
    spec = count_spectrum_packed(
        jnp.asarray(batch.words), jnp.asarray(batch.lengths), k=k, capacity=CAPACITY,
        length=tentry.READ_LEN,
    )
    spec = _slice_spectrum(spec, CORRECT_CAP)
    filtered = jcor.abundance_filter(spec, tentry.MIN_ABUNDANCE)
    want = jcor.sibling_prune_round(filtered, k, jnp.float32(tentry.SIBLING_RATIO))
    assert int(want.n) < int(filtered.n)  # the round prunes something

    step = tentry.make_step(k, CAPACITY, CORRECT_CAP, tentry.READ_LEN)
    key, count, n = step(upload_words(batch.words, "cpu"), torch.from_numpy(batch.lengths))
    hi, lo, cnt, got_n = convert.spectrum_to_numpy(Spectrum(key=key, count=count, n=n))
    assert got_n == int(want.n)
    np.testing.assert_array_equal(hi, np.asarray(want.hi))
    np.testing.assert_array_equal(lo, np.asarray(want.lo))
    np.testing.assert_array_equal(cnt, np.asarray(want.count))


def test_entry_gives_the_flagship_arguments(monkeypatch):
    """entry(device="cpu") builds the flagship batch without running the
    step: the step never reaches the counter."""
    def no_count(*args, **kwargs):
        raise AssertionError("entry() ran the step")

    monkeypatch.setattr(tentry, "count_spectrum_packed", no_count)
    step, (words, lengths) = tentry.entry(device="cpu")
    assert callable(step)
    assert words.shape == (tentry.N_READS, 7) and words.dtype == torch.int32
    assert lengths.shape == (tentry.N_READS,) and lengths.dtype == torch.int32
    assert words.device.type == lengths.device.type == "cpu"
    assert (lengths == tentry.READ_LEN).all()


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multichip_matches_reference(n_devices, capsys):
    """The port's dry run on n CPU shards passes its own checks, and its
    figures (corrected k-mers, contigs, threading events, transcripts)
    equal those the reference's prints for n virtual devices."""
    graft.dryrun_multichip(n_devices)
    line = capsys.readouterr().out
    want = re.search(r"(\d+) corrected k-mers, (\d+) contigs, (\d+) threading events, "
                     r"(\d+) transcripts", line)
    assert want, line
    got = tentry.dryrun_multichip(n_devices, device="cpu")
    assert [got[key] for key in ("corrected_kmers", "contigs", "threading_events",
                                 "transcripts")] == [int(x) for x in want.groups()]


def test_dryrun_multichip_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(8)
