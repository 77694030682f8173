"""repro_torch's data feed against the reference's (`repro.data`), on the
CPU: the synthetic stream bit for bit, the splitter's slices, the
distributor's batches, and the double-buffered feed's error relay,
close() and stall report (the reference's own checks, as in
`tests/test_data_pipeline.py`)."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import time
import types

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.core.overlap import overlap_report
from repro_torch.data import (BatchSpec, Distributor, DoubleBufferedFeed,
                              Splitter, SyntheticLMStream, stream_batches)


@pytest.mark.parametrize("seed,step,lo,hi,vocab", [
    (0, 0, 0, None, 1000), (7, 42, 0, 4, 1000), (3, 5, 2, 5, 100),
    (11, 1_000_003, 1, 2, 151_936)])
def test_stream_is_bit_equal_to_the_reference(seed, step, lo, hi, vocab):
    spec = BatchSpec(global_batch=6, seq_len=16, vocab=vocab)
    got = SyntheticLMStream(spec, seed).batch(step, lo, hi)
    want = jpipe.SyntheticLMStream(jpipe.BatchSpec(6, 16, vocab),
                                   seed).batch(step, lo, hi)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_stream_stateless_and_shifted():
    spec = BatchSpec(global_batch=4, seq_len=8, vocab=100)
    s = SyntheticLMStream(spec, seed=1)
    np.testing.assert_array_equal(s.batch(3)["tokens"],
                                  SyntheticLMStream(spec, 1).batch(3)["tokens"])
    b = s.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    np.testing.assert_array_equal(s.batch(5)["tokens"][1:3],
                                  s.batch(5, lo=1, hi=3)["tokens"])


@pytest.mark.parametrize("shards", range(1, 9))
@pytest.mark.parametrize("global_batch", [4, 6, 8, 12])
def test_splitter_slices_equal_the_reference(shards, global_batch):
    """The port's splitter takes its devices, the reference's a mesh and
    its batch axes: the same number of shards gives the same slices."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shards, "model": 1})
    want = jpipe.Splitter(mesh, ("pod", "data")).slices(global_batch)
    got = Splitter(["cpu"] * shards).slices(global_batch)
    assert got == want
    assert sorted(x for lo, hi in got for x in range(lo, hi)) == \
        list(range(global_batch))


def test_distributor_materializes_the_global_batch_on_the_device():
    spec = BatchSpec(global_batch=6, seq_len=8, vocab=50)
    stream = SyntheticLMStream(spec, seed=2)
    dist = Distributor(["cpu"] * 3, Splitter(["cpu"] * 3))
    assert dist.local_slices(6) == [(0, 2), (2, 4), (4, 6)]
    batch = dist.materialize(stream, 4, "cpu")
    want = stream.batch(4)
    for key in want:
        assert batch[key].device.type == "cpu"
        assert batch[key].dtype == torch.int32
        np.testing.assert_array_equal(batch[key].numpy(), want[key])
    it = stream_batches(stream, dist, "cpu", start_step=4)
    np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                  want["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                  stream.batch(5)["tokens"])


def test_feed_delivers_in_order_from_its_start_step():
    feed = DoubleBufferedFeed(lambda step: {"step": step}, depth=2,
                              start_step=5)
    for want in range(5, 9):
        step, batch = next(feed)
        assert step == batch["step"] == want
    feed.close()
    assert len(feed.transfer_seconds) >= 4


def test_feed_propagates_producer_error():
    def make(step):
        if step == 2:
            raise ValueError("bad batch")
        return {"step": step}

    feed = DoubleBufferedFeed(make, depth=2)
    assert next(feed)[0] == 0
    assert next(feed)[0] == 1
    with pytest.raises(RuntimeError, match="producer failed") as ei:
        next(feed)
    assert isinstance(ei.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(feed)                          # sticky, never blocks
    feed.close()


def test_feed_error_before_first_batch():
    def make(step):
        raise OSError("disk gone")

    feed = DoubleBufferedFeed(make, depth=2)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(feed)
    feed.close()


def test_feed_close_idempotent():
    feed = DoubleBufferedFeed(lambda step: {"step": step}, depth=2)
    next(feed)
    feed.close()
    feed.close()
    assert not feed._thread.is_alive()


def test_feed_stall_report():
    def make(step):
        time.sleep(0.005)
        return {"step": step}

    feed = DoubleBufferedFeed(make, depth=2)
    for _ in range(4):
        next(feed)
        time.sleep(0.01)                    # compute longer than transfer
    report = feed.stall_report()
    feed.close()
    assert len(feed.consumer_wait_seconds) >= 4
    assert report["produce_s"] > 0
    assert report["overlap_pct"] > 50.0
    assert report["hidden_s"] <= report["produce_s"]


def test_overlap_report_equals_the_reference():
    from repro.core.overlap import overlap_report as joverlap
    for args in ((1.0, 0.25), (0.5, 0.75), (0.0, 0.0)):
        assert overlap_report(*args) == joverlap(*args)
