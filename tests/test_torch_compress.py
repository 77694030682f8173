"""repro_torch's gradient compression, coordination and elastic restore
against the reference's (`repro.optim.compress`,
`repro.runtime.coordination`, `CheckpointManager.restore(shardings=)`).

* `quantize_int8`'s codes and scales, `dequantize_int8` and
  `compress_decompress` (bf16, int8_ef) are bit-equal to the reference's
  on the same f32 inputs (seeded numpy, several scales, zeros, a lone
  spike); `wire_bytes` counts the same; an unknown method raises in both.
* `compressed_psum` over a gloo group of one equals the reference's under
  `shard_map` on a one-device mesh (reduced values and error state, bit
  for bit, with error feedback carried over three steps); without a
  group it raises, naming the argument. A two-process gloo run (a
  `FileStore` under `tmp_path`) returns the sum of both ranks'
  compressed gradients and each rank's error feedback, checked against
  numpy (bf16 sums rounded once to bf16).
* `Coordinator` events and `replan_mesh_shape` equal the reference's on a
  grid, errors included.
* `restore(shardings=)` puts each leaf on the device asked for (one
  device, or a tree with None for "as `like`"), bit for bit; and
  `examples/elastic_restart_torch.py` runs on the CPU.

Tolerance: none (bits equal), except the bf16 two-rank sum, checked
exactly against numpy's once-rounded sum. Data: seeded numpy arrays.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.optim import compress as jc
from repro.runtime import coordination as jcoord
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.optim import compress as tc
from repro_torch.runtime import coordination as tcoord

ROOT = Path(__file__).resolve().parents[1]


def _inputs():
    rng = np.random.default_rng(11)
    out = {"normal": rng.normal(size=(64, 33)).astype(np.float32),
           "tiny": (rng.normal(size=257) * 1e-6).astype(np.float32),
           "huge": (rng.normal(size=(8, 8)) * 3e4).astype(np.float32),
           "zeros": np.zeros(17, np.float32),
           "spike": np.zeros(40, np.float32)}
    out["spike"][7] = -5.25
    out["halves"] = (np.arange(-20, 21, dtype=np.float32) * 0.5)
    return out


INPUTS = _inputs()


def _bits(a) -> np.ndarray:
    a = np.asarray(a).reshape(-1)
    return a.view(np.uint8) if a.dtype != np.int8 else a


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_int8_codes_scales_and_round_trips_are_the_references(name):
    x = INPUTS[name]
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()).tobytes() == _bits(np.float32(js)).tobytes()
    np.testing.assert_array_equal(
        _bits(tc.dequantize_int8(tq, ts).numpy()),
        _bits(jc.dequantize_int8(jq, js)))
    for method in ("bf16", "int8_ef"):
        got = tc.compress_decompress(torch.from_numpy(x), method).numpy()
        want = np.asarray(jc.compress_decompress(jnp.asarray(x), method))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wire_bytes_and_unknown_method():
    grads = {"w": torch.zeros(1000), "b": [torch.zeros(24)]}
    jgrads = {"w": jnp.zeros((1000,)), "b": [jnp.zeros((24,))]}
    for method in ("none", "bf16", "int8_ef"):
        assert tc.wire_bytes(grads, method) == jc.wire_bytes(jgrads, method)
    assert tc.wire_bytes(grads, "bf16") == 2048.0
    with pytest.raises(ValueError):
        tc.compress_decompress(torch.zeros(3), "fp4")
    with pytest.raises(ValueError):
        jc.compress_decompress(jnp.zeros(3), "fp4")


@pytest.fixture
def gloo_one(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32) * 0.01,
            "b": [rng.normal(size=8).astype(np.float32),
                  (rng.normal(size=3) * 50).astype(np.float32)]}


@pytest.mark.parametrize("method", ["bf16", "int8_ef"])
def test_compressed_psum_of_one_equals_shard_map(gloo_one, method):
    from jax.sharding import PartitionSpec as P

    from repro.core.compat import make_mesh, shard_map

    mesh = make_mesh((1,), ("data",))

    @partial(shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def run(g, e):
        return jc.compressed_psum(g, "data", method, e)

    terr = jerr = None
    for step in range(3):                       # error feedback carried
        g = _grads(step)
        jg = jax.tree.map(jnp.asarray, g)
        tg = jax.tree.map(torch.from_numpy, g)
        if jerr is None:
            jerr = jax.tree.map(jnp.zeros_like, jg)
        jred, jerr = run(jg, jerr)
        tred, terr = tc.compressed_psum(tg, gloo_one, method, terr)
        for a, b in zip(jax.tree.leaves(tred), jax.tree.leaves(jred)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        for a, b in zip(jax.tree.leaves(terr), jax.tree.leaves(jerr)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        assert isinstance(tred["b"], list) and len(tred["b"]) == 2


def test_compressed_psum_needs_a_group():
    with pytest.raises(ValueError, match="`group`"):
        tc.compressed_psum({"w": torch.ones(4)}, None)
    with pytest.raises(TypeError):
        tc.compressed_psum({"w": torch.ones(4)})       # no group argument


@pytest.mark.parametrize("method", ["bf16", "int8_ef"])
def test_compressed_psum_two_ranks_sums_against_numpy(tmp_path, method):
    ranks = torch_ranks.run_ranks(
        [("compressed_psum", dict(grads=[_grads(100 + r) for r in range(2)],
                                  method=method))], 2, tmp_path)
    outs = [{f"arr_{i}": a for i, a in enumerate(r[0])} for r in ranks]
    gs = [jax.tree.leaves(_grads(100 + r)) for r in range(2)]
    n = len(gs[0])
    sents = []
    for r in range(2):
        sent = []
        for i, g in enumerate(gs[r]):
            if method == "bf16":
                s = g.astype(ml_dtypes.bfloat16).astype(np.float32)
            else:
                scale = np.float32(max(np.abs(g).max(), np.float32(1e-12))
                                   / np.float32(127.0))
                q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
                s = q.astype(np.float32) * scale
            sent.append(s)
            # each rank's error feedback: what its wire lost
            np.testing.assert_array_equal(outs[r][f"arr_{n + i}"], g - s)
        sents.append(sent)
    for i in range(n):
        total = sents[0][i] + sents[1][i]
        if method == "bf16":
            total = total.astype(ml_dtypes.bfloat16).astype(np.float32)
        for r in range(2):
            np.testing.assert_array_equal(outs[r][f"arr_{i}"], total)


def test_coordinator_and_replan_equal_the_reference():
    seen = {"ref": [], "port": []}
    cj, ct = jcoord.Coordinator(n_hosts=4), tcoord.Coordinator(n_hosts=4)
    cj.subscribe(lambda ev: seen["ref"].append((ev.kind, ev.host)))
    ct.subscribe(lambda ev: seen["port"].append((ev.kind, ev.host)))
    script = [("leave", "h1"), ("preempt-notice", "h2"), ("join", "h9"),
              ("leave", "h2"), ("leave", "h3")]
    for kind, host in script:
        cj.emit(kind, host)
        ct.emit(kind, host)
        assert ct.n_hosts == cj.n_hosts
    assert seen["port"] == seen["ref"] == script
    assert [(e.kind, e.host) for e in ct.events] == script
    assert all(isinstance(e.time, float) for e in ct.events)
    for n_chips in (1, 4, 8, 15, 16, 240, 256, 257, 512, 1000, 4096):
        for mp_ in (1, 2, 4, 16):
            for pods in (1, 2, 4):
                try:
                    want = jcoord.replan_mesh_shape(
                        n_chips, model_parallel=mp_, pods=pods)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        tcoord.replan_mesh_shape(n_chips,
                                                 model_parallel=mp_,
                                                 pods=pods)
                    continue
                assert tcoord.replan_mesh_shape(
                    n_chips, model_parallel=mp_, pods=pods) == want


def _state():
    rng = np.random.default_rng(4)
    return {"params": {"w": torch.from_numpy(
                rng.normal(size=(6, 5)).astype(np.float32)).to(
                torch.bfloat16),
                       "b": [torch.arange(3, dtype=torch.int32)]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": np.arange(4, dtype=np.float32)}}


def test_restore_places_each_leaf_where_asked(tmp_path):
    st = _state()
    mgr = TManager(tmp_path, async_save=False)
    mgr.save(3, st)
    like = {"params": {"w": torch.zeros(6, 5, dtype=torch.bfloat16),
                       "b": [torch.zeros(3, dtype=torch.int32)]},
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "m": np.zeros(4, np.float32)}}
    cpu = torch.device("cpu")
    for shardings in ("cpu", cpu,
                      {"params": {"w": cpu, "b": [None]},
                       "opt": {"step": None, "m": "cpu"}}):
        got = mgr.restore(3, like, shardings=shardings)
        assert torch.equal(got["params"]["w"].view(torch.int16),
                           st["params"]["w"].view(torch.int16))
        assert got["params"]["w"].device == cpu
        assert torch.equal(got["params"]["b"][0], st["params"]["b"][0])
        assert int(got["opt"]["step"]) == 7
        # a leaf given a device comes back as a tensor on it
        assert isinstance(got["opt"]["m"], torch.Tensor)
        np.testing.assert_array_equal(got["opt"]["m"].numpy(),
                                      st["opt"]["m"])
    # without shardings, `like`'s kinds: the numpy leaf stays numpy
    got = mgr.restore(3, like)
    assert isinstance(got["opt"]["m"], np.ndarray)
    # the reference restores the port's step with its own shardings
    jgot = JManager(tmp_path).restore(3, jax.tree.map(
        np.asarray, {"params": {"w": np.zeros((6, 5), ml_dtypes.bfloat16),
                                "b": [np.zeros(3, np.int32)]},
                     "opt": {"step": np.int32(0),
                             "m": np.zeros(4, np.float32)}}))
    np.testing.assert_array_equal(
        np.asarray(jgot["params"]["w"]).view(np.int16),
        st["params"]["w"].view(torch.int16).numpy())


def test_elastic_restart_example_on_cpu(tmp_path, capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import elastic_restart_torch as ex
    finally:
        sys.path.pop(0)
    out = ex.main(["--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    assert out["fed"] == list(range(10)) and out["final_step"] == 10
    assert np.isfinite(out["loss"])
    assert out["mesh"] == (128, 1)
    text = capsys.readouterr().out
    assert "restored step 7 bit-exactly onto cpu" in text
