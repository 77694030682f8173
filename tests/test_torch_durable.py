"""repro_torch's durability layer against the reference's
(`repro.runtime.journal`, `repro.checkpoint.manager`, crash and restore).

* Journal: a journal written by either package replays in the other to
  equal `ReplaySummary`s (tags, terminal statuses, committed tokens);
  torn tails, alien headers, `compact` and a reopened journal's seq
  continuation read the same in both.
* `CheckpointManager`: bf16 leaves round-trip bit for bit without
  `ml_dtypes` (the port views them as int16); either package restores
  the other's step directories and session files; a stale tmp directory
  is never a checkpoint, `keep` collects old steps, a failed async
  write raises once on `wait()` and on the next `save()`;
  `restore_session` writes in place (every tensor keeps its storage) and
  skips the captured step graph.
* Crash and restore of the paged `qwen3-14b-smoke` session: a scripted
  crash at several chunks, journal only and with snapshots; the tokens
  committed before the crash and those delivered after the restore are
  each request's fault-free tokens from the reference's session, every
  token once; the restore's counters equal the reference's own crash and
  restore of the same script.

Tolerance: none (tokens, bits and counters equal). Data: seeded numpy
prompts and tensors; the reference's parameters and caches in f32
(`torch_parity.f32_state_factory`); `retry_backoff_s=0` on both sides.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeSessionProgram as JSession
from repro.runtime import faults as jfaults
from repro.runtime import journal as jjournal
from repro_torch import weights
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeSessionProgram as TSession
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import journal as tjournal
from torch_parity import f32_state_factory

JOURNALS = {"ref": jjournal, "port": tjournal}


# ----------------------------------------------------------------------------
# journal
# ----------------------------------------------------------------------------

def _write_events(mod, path, tag=None):
    j = mod.Journal(path, tag=tag)
    j.append({"ev": "submit", "rid": 0, "prompt": [1, 2], "max_new": 4,
              "klass": "throughput", "deadline_s": None})
    j.append({"ev": "submit", "rid": 1, "prompt": [3], "max_new": 2,
              "klass": "best_effort", "deadline_s": 0.5})
    j.append({"ev": "admit", "rid": 0, "slot": 2, "chunk": 0})
    j.append({"ev": "commit", "rid": 0, "tokens": [5, 9], "chunk": 0})
    j.commit()
    j.append({"ev": "snapshot", "step": 1})
    j.append({"ev": "commit", "rid": 0, "tokens": [4, 4], "chunk": 1})
    j.append({"ev": "finish", "rid": 0, "status": "done", "reason": None})
    j.append({"ev": "finish", "rid": 1, "status": "failed",
              "reason": "shed"})
    j.append({"ev": "restore", "snapshot_step": 1, "replayed": 0,
              "restore_s": 0.01})
    j.commit()
    j.close()


def _summary(mod, path):
    return dataclasses.asdict(mod.replay(mod.read_events(path)))


@pytest.mark.parametrize("tag", [None, {"group": 1}])
@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_journal_replays_across_packages(tmp_path, writer, reader, tag):
    path = tmp_path / "journal.jsonl"
    _write_events(JOURNALS[writer], path, tag)
    got = _summary(JOURNALS[reader], path)
    assert got == _summary(JOURNALS[writer], path)
    assert got["requests"][0]["committed"] == [5, 9, 4, 4]
    assert got["requests"][1]["reason"] == "shed"
    assert got["snapshots"] == [(4, 1)] and got["restores"] == 1


def test_journal_torn_tail_alien_header_compact_and_seq(tmp_path):
    path = tmp_path / "j.jsonl"
    _write_events(tjournal, path)
    with open(path, "a") as f:
        f.write('{"seq": 10, "ev": "commit", "rid": 0, "tok')    # torn
    assert tjournal.read_events(path) == jjournal.read_events(path)
    assert len(tjournal.read_events(path)) == 9
    # a reopened journal continues the seq of the durable prefix
    j = tjournal.Journal(path)
    assert j.seq == jjournal.Journal(path).seq == 9
    # compact: the port rewrites, the reference reads the same events
    evs = tjournal.read_events(path)[3:]
    j.compact(evs)
    assert jjournal.read_events(path) == evs
    assert tjournal.Journal(path).seq == 9
    # an alien header is a cold start in both
    alien = tmp_path / "alien.jsonl"
    alien.write_text(json.dumps({"version": 99, "kind": "x"}) + "\n"
                     + json.dumps({"seq": 0, "ev": "snapshot", "step": 1})
                     + "\n")
    assert tjournal.read_events(alien) == jjournal.read_events(alien) == []
    assert tjournal.Journal(alien).seq == 0
    assert tjournal.read_events(alien) == []
    with pytest.raises(ValueError):
        tjournal.Journal(tmp_path / "k.jsonl").append({"ev": "nope"})


# ----------------------------------------------------------------------------
# checkpoint manager
# ----------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g).bfloat16(),
                       "b": torch.randn(16, generator=g)},
            "step": torch.tensor([7], dtype=torch.int32),
            "blocks": [torch.arange(6, dtype=torch.int32).reshape(2, 3)]}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(tree.numpy())


def test_checkpoint_bf16_round_trips_across_packages(tmp_path):
    state = _state()
    tm = TManager(tmp_path / "port", async_save=False)
    tm.save(3, state)
    got = tm.restore(3, _state(1))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))
    # the reference reads the port's step directory ...
    ref = JManager(tmp_path / "port").restore(3, _to_jax(state))
    w = np.asarray(ref["params"]["w"])
    assert w.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        w.view(np.int16), state["params"]["w"].view(torch.int16).numpy())
    # ... and the port reads the reference's
    jm = JManager(tmp_path / "ref", async_save=False)
    jm.save(4, _to_jax(state))
    back = TManager(tmp_path / "ref").restore(4, _state(2))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_checkpoint_atomic_keep_and_async_errors(tmp_path, monkeypatch):
    m = TManager(tmp_path, keep=2, async_save=True)
    (tmp_path / ".tmp-99").mkdir()
    (tmp_path / ".tmp-99" / "garbage").write_text("x")
    for s in (1, 2, 3):
        m.save(s, _state(s))
    m.wait()
    assert m.all_steps() == [2, 3] and m.latest_step() == 3

    def boom(step, snapshot):
        raise OSError("disk full")

    monkeypatch.setattr(m, "_write_step", boom)
    m.save(4, _state())
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    m.wait()                                    # raised once, then cleared
    m.save(5, _state())
    with pytest.raises(OSError, match="disk full"):
        m.save(6, _state())
    monkeypatch.undo()
    m.save(7, _state())
    m.wait()
    assert m.latest_step() == 7


def test_async_save_holds_the_state_it_was_given(tmp_path, monkeypatch):
    """An async save of host tensors (and a numpy leaf) writes the values
    they held when `save` returned, though the caller updates them in
    place before the writer runs: the snapshot is a copy."""
    import threading
    state = dict(_state(), host=np.arange(6, dtype=np.float32))
    want = {"params": {k: v.clone() for k, v in state["params"].items()},
            "step": state["step"].clone(), "blocks": [state["blocks"][0]
                                                      .clone()],
            "host": state["host"].copy()}
    m = TManager(tmp_path, async_save=True)
    go = threading.Event()
    write = m._write_step

    def held(step, snapshot):
        assert go.wait(30)
        write(step, snapshot)

    monkeypatch.setattr(m, "_write_step", held)
    m.save(1, state)
    for leaf in jax.tree.leaves({k: v for k, v in state.items()
                                 if k != "host"}):
        leaf.add_(1)
    state["host"] += 1.0
    go.set()
    m.wait()
    got = m.restore(1, state)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert torch.equal(_bits(a), _bits(b))


def test_session_snapshot_in_place_and_across_packages(tmp_path):
    state = dict(_state(), step_graph=object())
    m = TManager(tmp_path, keep=2, async_save=False)
    for step in (1, 2, 3):
        m.save_session(step, state, {"chunk_index": step})
    assert m.session_steps() == [2, 3] and m.latest_session_step() == 3
    like = dict(_state(5), step_graph="graph")
    ptrs = [t.data_ptr() for t in jax.tree.leaves(
        {k: v for k, v in like.items() if k != "step_graph"})]
    out, meta = m.restore_session(3, like)
    assert meta == {"chunk_index": 3} and out["step_graph"] == "graph"
    for a, b in zip(jax.tree.leaves(_state()), jax.tree.leaves(
            {k: v for k, v in like.items() if k != "step_graph"})):
        assert torch.equal(_bits(a), _bits(b))
    assert ptrs == [t.data_ptr() for t in jax.tree.leaves(
        {k: v for k, v in like.items() if k != "step_graph"})]
    # the reference reads the port's session file and the other way round
    jstate, jmeta = JManager(tmp_path).restore_session(3, _to_jax(_state()))
    assert jmeta == meta and np.asarray(jstate["params"]["w"]).view(
        np.int16).tolist() == _state()["params"]["w"].view(
        torch.int16).tolist()
    JManager(tmp_path / "j").save_session(9, _to_jax(_state()), {"x": 1})
    got, _ = TManager(tmp_path / "j").restore_session(9, _state(4))
    assert torch.equal(_bits(got["params"]["w"]),
                       _bits(_state()["params"]["w"]))
    bad = _state()
    bad["params"]["b"] = torch.zeros(16, dtype=torch.float16)
    with pytest.raises(ValueError, match="params/b"):
        m.restore_session(3, bad)


# ----------------------------------------------------------------------------
# crash and restore
# ----------------------------------------------------------------------------

SPEC = dict(slots=3, max_seq=48, max_prompt=16, chunk=2, paged=True,
            page_size=4, retry_backoff_s=0.0)


def _requests():
    rng = np.random.default_rng(5)
    pre = rng.integers(1, 200, 8)
    return [((np.concatenate([pre, rng.integers(1, 200, 2)]) if i % 2
              else rng.integers(1, 200, int(rng.integers(2, 9))))
             .astype(np.int32), int(rng.integers(3, 9))) for i in range(7)]


@pytest.fixture(scope="module")
def progs():
    jprog = f32_state_factory(JCluster("qwen3-14b-smoke").compile(
        JSession(**SPEC)))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jprog.init_params())
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tprog = f32_state_factory(TCluster("qwen3-14b-smoke",
                                       device="cpu").compile(
        TSession(**SPEC)))
    ref = jprog.open(params=jp)
    hs = [ref.submit(p, n) for p, n in _requests()]
    ref.drain()
    expected = {h.id: h.result().tolist() for h in hs}
    return jprog, jp, tprog, tp, expected


def _crash_and_restore(prog, params, faults, d, snap, crash_at):
    """Serve with a scripted crash; restore; drain. Returns (tokens
    delivered before the crash, journal-committed tokens, final streams,
    the restored session's durability counters)."""
    sess = prog.open(params=params, durable_dir=d, snapshot_every=snap,
                     faults=faults.FaultPlan().crash(at_chunk=crash_at))
    for p, n in _requests():
        sess.submit(p, n)
    delivered = {}
    with pytest.raises(faults.SessionCrashed):
        while sess.busy:
            for h, toks, _ in sess.poll():
                delivered.setdefault(h.id, []).extend(int(t) for t in toks)
    journal = jjournal if faults is jfaults else tjournal
    committed = {rid: list(r.committed) for rid, r in journal.replay(
        journal.read_events(d / "journal.jsonl")).requests.items()}
    restored = prog.restore(d, params=params)
    final = {rid: list(t) for rid, t in committed.items()}
    for h, toks, _ in restored.stream():
        final.setdefault(h.id, []).extend(int(t) for t in toks)
    return delivered, committed, final, restored.stats()["durability"]


@pytest.mark.parametrize("snap", [None, 2], ids=["journal", "snapshots"])
@pytest.mark.parametrize("crash_at", [1, 4, 7])
def test_crash_and_restore_exactly_once(progs, tmp_path, crash_at, snap):
    jprog, jp, tprog, tp, expected = progs
    delivered, committed, final, du = _crash_and_restore(
        tprog, tp, tfaults, tmp_path / "port", snap, crash_at)
    for rid, toks in delivered.items():     # delivered only once durable
        assert committed[rid][:len(toks)] == toks
    assert final == expected                # every token once, bit equal
    assert du["restore_s"] > 0 and du["replayed_requests"] > 0
    # the crash fires at the end of chunk `crash_at`'s poll, after the
    # snapshot of that boundary (chunk index crash_at + 1)
    assert (du["restored_step"] is not None) == (snap is not None
                                                 and crash_at + 1 >= snap)
    *_, jdu = _crash_and_restore(jprog, jp, jfaults, tmp_path / "ref", snap,
                                 crash_at)
    for key in ("restored_step", "replayed_requests", "resubmitted",
                "recovered_terminal", "deduped_tokens", "snapshots",
                "journal_events"):
        assert du[key] == jdu[key], key


def test_serve_chaos_example_crash_drill_on_cpu():
    """examples/serve_chaos_torch.py --crash on the CPU: the child is
    SIGKILLed at its scripted chunk and the parent's restore delivers
    every token once, equal to its fault-free run (exit code 0)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_chaos_torch.py"),
         "--crash", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "child killed -9" in proc.stdout
    assert "bit_identical=yes exactly_once=yes" in proc.stdout
