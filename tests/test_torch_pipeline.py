"""The port's HTAP-fed token pipeline (`repro_torch.data`) against the JAX
package's (`repro.data`): the four cases of tests/test_pipeline.py on the
CPU, and a seeded ingest / propagate / `get_batch` schedule whose batches
and `freshness_lag` must equal the reference's bit for bit, on the
``hopper`` backend (its kernels' plain versions here) and on ``torch``.
"""

import numpy as np
import pytest
import torch

from repro.data import HTAPTokenPipeline as RefPipeline
from repro.data import SyntheticPipeline as RefSynthetic
from repro_torch.data import HTAPTokenPipeline, SyntheticPipeline

torch.set_num_threads(1)


def _pipe(**kw):
    return HTAPTokenPipeline(device="cpu", **kw)


def test_batch_shapes_and_determinism():
    pipe = _pipe(vocab_size=100, seq_len=16, batch=4, initial_tokens=2048)
    t1, l1 = pipe.get_batch(3)
    t2, l2 = pipe.get_batch(3)
    assert t1.shape == (4, 16) and t1.dtype == torch.int32
    assert l1.dtype == torch.int32 and t1.device.type == "cpu"
    assert torch.equal(t1, t2)                     # pure function of step
    assert torch.equal(t1[:, 1:], l1[:, :-1])      # shifted labels


def test_ingest_propagate_freshness():
    pipe = _pipe(vocab_size=100, seq_len=8, batch=2, initial_tokens=1024)
    marker = np.full(512, 77, dtype=np.int32)
    pipe.ingest(marker)
    assert pipe.freshness_lag() == 512             # ingested, not yet visible
    applied = pipe.propagate()
    assert applied == 512
    assert pipe.freshness_lag() == 0               # §6 freshness restored
    # the new tokens are readable through a consistent snapshot
    head = pipe.replica.columns[0]
    data = head.dictionary[head.codes.long()]
    assert (data[-512:] == 77).all()


def test_reader_isolation_during_ingest():
    pipe = _pipe(vocab_size=100, seq_len=8, batch=2, initial_tokens=1024)
    t1, _ = pipe.get_batch(0)
    pipe.ingest(np.full(256, 5, dtype=np.int32))   # not propagated yet
    t2, _ = pipe.get_batch(0)
    assert torch.equal(t1, t2)                     # isolation


def test_synthetic_pipeline_determinism():
    p = SyntheticPipeline(100, 8, 2, seed=3, device="cpu")
    a = p.get_batch(5)
    b = p.get_batch(5)
    assert torch.equal(a[0], b[0])
    c = p.get_batch(6)
    assert not torch.equal(a[0], c[0])


def test_synthetic_pipeline_equals_the_reference():
    ref = RefSynthetic(100, 8, 2, seed=3)
    got = SyntheticPipeline(100, 8, 2, seed=3, device="cpu")
    for step in range(4):
        for g, w in zip(got.get_batch(step), ref.get_batch(step)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("backend", ["hopper", "torch"])
def test_schedule_equals_the_reference_bit_for_bit(backend):
    """Ingest chunks of tokens drawn from a seeded generator (values that
    are new to the dictionary among them), propagate every other chunk
    (the last one left pending until the end),
    read batches between: every batch, every freshness lag and every
    applied count equal to the reference's."""
    kw = dict(vocab_size=300, seq_len=24, batch=3, seed=7,
              initial_tokens=600)
    ref = RefPipeline(**kw)
    got = HTAPTokenPipeline(backend=backend, device="cpu", **kw)
    feed = np.random.default_rng(11)
    for step in range(8):
        tokens = feed.integers(0, 400, size=97 + 13 * step)
        ref.ingest(tokens)
        got.ingest(tokens)
        assert got.freshness_lag() == ref.freshness_lag()
        if step % 2 == 0:
            assert got.propagate() == ref.propagate()
        assert got.freshness_lag() == ref.freshness_lag()
        for g, w in zip(got.get_batch(step), ref.get_batch(step)):
            assert g.dtype == torch.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
    assert got.propagate() == ref.propagate() > 0
    assert got.freshness_lag() == ref.freshness_lag() == 0
    for g, w in zip(got.get_batch(99), ref.get_batch(99)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_refusing_a_small_store_leaves_no_pinned_version():
    """A store shorter than one batch is refused (a `ValueError` here, an
    assertion in the reference) and, as in the reference, the refused
    read's snapshot is released: no handle stays pinned, and a read after
    enough tokens came in answers as the reference's does."""
    kw = dict(vocab_size=50, seq_len=16, batch=4, initial_tokens=40)
    ref = RefPipeline(**kw)
    got = HTAPTokenPipeline(backend="hopper", device="cpu", **kw)
    with pytest.raises(AssertionError, match="store too small"):
        ref.get_batch(0)
    with pytest.raises(ValueError, match="store too small: 40 < 68"):
        got.get_batch(0)
    assert ref.cons._handles == {} and got.cons._handles == {}
    tokens = np.random.default_rng(3).integers(0, 50, size=64)
    for pipe in (ref, got):
        pipe.ingest(tokens)
        pipe.propagate()
    for g, w in zip(got.get_batch(1), ref.get_batch(1)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got.cons._handles == {}
