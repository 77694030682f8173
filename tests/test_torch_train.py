"""repro_torch's training slice against the reference, on the CPU.

The same numpy inputs (and the reference's parameters, carried over with
`weights.from_jax_params` / `from_jax_train_state`) go through the
reference's functions and the port's:

* the four fused ops' VJPs (their `torch.autograd.Function`s; the
  reference's `custom_vjp`, its Pallas forward interpreted), the flash VJP
  of the chunked attention schedules, the chunked cross-entropy and the
  loss, every parameter's gradient of qwen3-14b-smoke, AdamW and the
  schedule, three train steps, grad accumulation;
* the train chunk against the step loop, the train loop's resume, the
  straggler detector, `TrainProgram` / `api.train` / the CLI / the
  example.

Tolerances: f32 values within 1e-5 (relative L2 for gradient trees and
parameters, which sum order alone moves); bf16 gradients within 2e-2
relative L2 per leaf (bf16 rounds at other places in the two packages:
sum order flips single roundings, which later layers carry). Parameters
after AdamW are compared by relative L2 (its first steps move each
element by about lr x sign(g), which a near-zero gradient's sum order can
flip). Losses of a bf16 run within 2e-2.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import os
import shutil
import signal
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import api as japi
from repro.cluster import session as jsession
from repro.cluster.policy import use_policy as juse
from repro.configs import get as jget
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import steps as jsteps
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.runtime import train_loop as jloop
from repro_torch import api as tapi
from repro_torch import weights
from repro_torch.cluster import session as tsession
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.configs import get as tget
from repro_torch.core.addressing import MeshSpec
from repro_torch.kernels import fused, launches, ops
from repro_torch.models import attention as tattn
from repro_torch.models import steps as tsteps
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import warmup_cosine
from repro_torch.runtime import engine as tengine
from repro_torch.runtime.train_loop import (StragglerDetector, TrainLoop,
                                            TrainLoopConfig)

ROOT = Path(__file__).resolve().parents[1]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "qwen3-14b-smoke"


def _sigterm():
    """SIGTERM to this process, which the train loop's handler (installed
    on the main thread only) turns into its preemption flag."""
    import threading
    assert threading.current_thread() is threading.main_thread()
    os.kill(os.getpid(), signal.SIGTERM)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _close_grads(got, want, dtype):
    """f32: 1e-5 relative L2; bf16: 2e-2 (see the module's note)."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert np.isfinite(_f32(g)).all()
        assert _rel(g, w) < tol, _rel(g, w)


# ----------------------------------------------------------------------------
# (a) the fused ops' VJPs
# ----------------------------------------------------------------------------

def _fused_inputs(name, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrays = {"rmsnorm_matmul": (r(12, 32), r(32, scale=0.1),
                                 r(32, 24, scale=32 ** -0.5)),
              "matmul_residual_add": (r(12, 40), r(40, 24, scale=40 ** -0.5),
                                      r(12, 24)),
              "matmul_bias_act": (r(12, 32), r(32, 24, scale=32 ** -0.5),
                                  r(24)),
              "flash_attention_proj": (r(2, 4, 12, 16), r(2, 2, 12, 16),
                                       r(2, 2, 12, 16),
                                       r(4, 16, 32, scale=0.1))}[name]
    return [_pair(a, dtype) for a in arrays]


FUSED = {"rmsnorm_matmul": (jops.rmsnorm_matmul, ops.rmsnorm_matmul,
                            ops.RmsnormMatmulFn, {}),
         "matmul_residual_add": (jops.matmul_residual_add,
                                 ops.matmul_residual_add,
                                 ops.MatmulResidualAddFn, {}),
         "matmul_bias_act": (jops.matmul_bias_act, ops.matmul_bias_act,
                             ops.MatmulBiasActFn, {"act": "gelu"}),
         "flash_attention_proj": (jops.flash_attention_proj,
                                  ops.flash_attention_proj,
                                  ops.FlashAttentionProjFn,
                                  {"causal": True})}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_op_vjp_matches_reference(name, dtype):
    """Every input's gradient against `jax.vjp` of the reference op under
    "fused" (its custom_vjp: the Pallas forward, the composition's
    backward); the output's grad_fn is the op's Function on the kernel
    route ("fused") and on the plain one ("interpret")."""
    jfn, tfn, fn_cls, kw = FUSED[name]
    pairs = _fused_inputs(name, dtype)
    jxs = [j for j, _ in pairs]
    with juse("fused"):
        jout, vjp = jax.vjp(lambda *xs: jfn(*xs, **kw), *jxs)
    ct = np.random.default_rng(1).standard_normal(jout.shape).astype(
        np.float32)
    jct, tct = _pair(ct, dtype)
    want = vjp(jct)
    for mode in ("fused", "interpret"):
        txs = [t.clone().requires_grad_() for _, t in pairs]
        with tuse(mode):
            out = tfn(*txs, **kw)
        assert type(out.grad_fn).__name__ == fn_cls.__name__ + "Backward"
        got = torch.autograd.grad(out, txs, tct)
        _close_grads(got, want, dtype)
    with torch.no_grad(), tuse("fused"):       # no grad: no Function
        assert tfn(*[t for _, t in pairs], **kw).grad_fn is None


def test_reference_mode_is_plain_autograd():
    """Under "reference" the fused ops are the oracles under autograd, as
    the reference's `_take_reference` route is."""
    pairs = _fused_inputs("rmsnorm_matmul", "float32")
    txs = [t.clone().requires_grad_() for _, t in pairs]
    with tuse("reference"):
        out = ops.rmsnorm_matmul(*txs)
    assert not type(out.grad_fn).__name__.startswith("RmsnormMatmulFn")
    with juse("reference"):
        jout, vjp = jax.vjp(jops.rmsnorm_matmul, *[j for j, _ in pairs])
    ct = np.ones(jout.shape, np.float32)
    _close_grads(torch.autograd.grad(out, txs, torch.from_numpy(ct)),
                 vjp(jnp.asarray(ct)), "float32")


def test_flash_attention_has_no_vjp_in_either_package():
    """The reference's flash_attention is a Pallas call with no VJP:
    `jax.grad` through it fails. The port's raises NotImplementedError
    under grad on its kernel and plain routes; without grad it runs."""
    (qj, qt), (kj, kt), (vj, vt) = [
        _pair(np.random.default_rng(i).standard_normal(
            (1, 2, 8, 16)).astype(np.float32), "float32") for i in range(3)]
    with juse("fused"), pytest.raises(Exception):
        jax.grad(lambda q: jops.flash_attention(q, kj, vj).sum())(qj)
    for mode in ("fused", "interpret"):
        with tuse(mode), pytest.raises(NotImplementedError, match="VJP"):
            ops.flash_attention(qt.clone().requires_grad_(), kt, vt)
        with tuse(mode):
            assert ops.flash_attention(qt, kt, vt).shape == qt.shape


def test_cpu_wrapper_result_keeps_its_gradient():
    """On the CPU a kernel wrapper runs its plain version, which autograd
    sees: never a detached result."""
    (_, x), (_, s), (_, w) = _fused_inputs("rmsnorm_matmul", "float32")
    x = x.clone().requires_grad_()
    y = fused.rmsnorm_matmul(x, s, w)
    assert y.grad_fn is not None
    assert torch.autograd.grad(y.sum(), x)[0].abs().max() > 0


# ----------------------------------------------------------------------------
# (b) the flash VJP of the chunked schedules
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule,s,window", [
    ("masked", 40, None), ("masked", 40, 16), ("folded", 48, None),
    ("banded", 40, 16), ("banded", 48, 8)])
def test_flash_vjp_matches_reference(schedule, s, window, dtype):
    """GQA (4 heads over 2), chunk 8 (S > 2 chunks): out and the q, k, v
    gradients of `attention.FlashFn` against the reference's `_flash`
    custom_vjp."""
    rng = np.random.default_rng(s + (window or 0))
    q, k, v = (_pair(rng.standard_normal(shape).astype(np.float32), dtype)
               for shape in ((2, s, 4, 16), (2, s, 2, 16), (2, s, 2, 16)))
    ct = _pair(rng.standard_normal((2, s, 4, 16)).astype(np.float32), dtype)
    jout, vjp = jax.vjp(lambda *a: jattn._flash(2, 8, window, schedule, *a),
                        q[0], k[0], v[0])
    txs = [t.clone().requires_grad_() for t in (q[1], k[1], v[1])]
    out = tattn.attention(*txs, n_kv=2, causal=True, window=window, chunk=8,
                          schedule=schedule)
    assert type(out.grad_fn).__name__ == "FlashFnBackward"
    _close_grads([out], [jout], dtype)
    _close_grads(torch.autograd.grad(out, txs, ct[1]), vjp(ct[0]), dtype)


# ----------------------------------------------------------------------------
# (c) the chunked cross-entropy and the loss
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("s", [520, 1024])
def test_chunked_ce_matches_reference(s):
    """S = 520 (above LOSS_CHUNK, not a multiple: one chunk of S) and
    1024 (two chunks); f32 value and gradients within 1e-5."""
    cfg_j = dataclasses.replace(jget(ARCH), vocab=64)
    cfg_t = dataclasses.replace(tget(ARCH), vocab=64)
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 64))).astype(np.float32)
    y = rng.integers(0, 64, (2, s)).astype(np.int32)
    jval, jg = jax.value_and_grad(
        lambda h_, w_: jsteps._chunked_ce(cfg_j, w_, h_, jnp.asarray(y)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tval = tsteps._chunked_ce(cfg_t, wt, ht, torch.from_numpy(y))
    assert abs(tval.item() - float(jval)) < 1e-5 * abs(float(jval))
    _close_grads(torch.autograd.grad(tval, (ht, wt)), jg, "float32")


@pytest.fixture(scope="module")
def smoke_params():
    """qwen3-14b-smoke's reference parameters in f32 and bf16, each with
    the port's copy."""
    jcfg = jget(ARCH)
    jp = jsteps.init_params(jcfg, jax.random.PRNGKey(0))
    out = {}
    for dtype in ("float32", "bfloat16"):
        j = jax.tree.map(lambda a: a.astype(JDT[dtype]), jp)
        out[dtype] = (j, weights.from_jax_params(jax.tree.map(np.asarray, j),
                                                 device="cpu"))
    return out


def _tokens(b=2, s=16, seed=3, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def test_loss_fn_matches_reference(smoke_params):
    jp, tp = smoke_params["float32"]
    batch = _tokens()
    jl, jparts = jsteps.loss_fn(jget(ARCH), jp, jax.tree.map(jnp.asarray,
                                                             batch))
    tl, tparts = tsteps.loss_fn(tget(ARCH), tp, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tparts) == sorted(jparts) == ["aux", "ce"]
    assert abs(float(tl) - float(jl)) < 1e-5 * float(jl)
    assert abs(float(tparts["ce"]) - float(jparts["ce"])) < 1e-5 * float(jl)
    assert float(tparts["aux"]) == float(jparts["aux"]) == 0.0


# ----------------------------------------------------------------------------
# (d) every parameter's gradient of qwen3-14b-smoke
# ----------------------------------------------------------------------------

_JGRADS = {}


def _ref_grads(smoke_params, policy, dtype):
    """The reference's loss and gradients (as the port's layout), once a
    (policy, dtype)."""
    if (policy, dtype) not in _JGRADS:
        jp, _ = smoke_params[dtype]
        batch = jax.tree.map(jnp.asarray, _tokens())
        with juse(policy):
            (loss, _), g = jax.value_and_grad(
                lambda p: jsteps.loss_fn(jget(ARCH), p, batch),
                has_aux=True)(jp)
        _JGRADS[policy, dtype] = (float(loss), weights.from_jax_params(
            jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), g),
            device="cpu"))
    return _JGRADS[policy, dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["nothing", "none"])
@pytest.mark.parametrize("policy", ["fused", "tuned"])
def test_param_grads_match_reference(smoke_params, policy, remat, dtype):
    """Every leaf's gradient (`make_train_step(...).accumulate`) against
    `jax.value_and_grad` of the reference's loss, per leaf: f32 1e-5,
    bf16 2e-2 relative L2; none is all zero."""
    _, tp = smoke_params[dtype]
    cfg = dataclasses.replace(tget(ARCH), remat=remat)
    jloss, jg = _ref_grads(smoke_params, policy, dtype)
    batch = {k: torch.from_numpy(v) for k, v in _tokens().items()}
    loss, parts, g = tsteps.make_train_step(cfg, policy=policy).accumulate(
        tp, batch)
    assert abs(float(loss) - jloss) < (1e-5 if dtype == "float32"
                                       else 2e-2) * jloss
    assert sorted(parts) == ["aux", "ce"]
    tol = 1e-5 if dtype == "float32" else 2e-2
    leaves_t = pytree.tree_flatten_with_path(g)[0]
    leaves_j = pytree.tree_leaves(jg)
    assert len(leaves_t) == len(leaves_j)
    for (path, a), b in zip(leaves_t, leaves_j):
        assert a.dtype == TDT[dtype]
        assert np.abs(_f32(a)).max() > 0, pytree.keystr(path)
        assert _rel(a, b) < tol, (pytree.keystr(path), _rel(a, b))


def test_remat_is_recomputation(smoke_params, monkeypatch):
    """Under remat "nothing" forward keeps each layer's inputs and runs
    the layer again in backward (its fused kernels launch twice); "none"
    runs it once; "dots" and "dots_no_batch" run it again too (nothing
    of a fused kernel is kept, as in the reference), and serve without
    grad."""
    _, tp = smoke_params["float32"]
    batch = {k: torch.from_numpy(v) for k, v in _tokens().items()}
    cfg = tget(ARCH)
    calls = []
    real = fused.rmsnorm_matmul_plain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused, "rmsnorm_matmul_plain", counting)
    for remat, want in (("nothing", 2), ("none", 1), ("dots", 2),
                        ("dots_no_batch", 2)):
        calls.clear()
        tsteps.make_train_step(dataclasses.replace(cfg, remat=remat),
                               policy="fused").accumulate(tp, batch)
        assert len(calls) == want * 5 * cfg.n_layers, remat
    dots = dataclasses.replace(cfg, remat="dots")
    with torch.no_grad():
        hidden, _ = tsteps.forward(dots, tp, batch["tokens"])
    assert hidden.shape == (2, 16, cfg.d_model)


# ----------------------------------------------------------------------------
# (e)-(h) the optimizer, the schedule, the step, the chunk
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("slice_", [tadamw.SLICE, 7])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adam_update_matches_reference(moments, slice_, monkeypatch):
    """Two AdamW updates with the clip active (grad_clip 0.5 against a
    norm of ~10), bf16 and f32 parameters, lr_scale 0.5, in place; with
    SLICE cut to 7 the leaves are updated 7 elements at a time. Params,
    moments (f32 within 1e-6 relative L2; bf16 moments within one bf16
    rounding, 1e-2), step and grad_norm against the reference."""
    monkeypatch.setattr(tadamw, "SLICE", slice_)
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 6), "b": {"c": (10,), "d": (3, 3, 2)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    p = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    p["b"]["c"] = p["b"]["c"].astype(jnp.bfloat16)
    cfg_j = jadamw.AdamConfig(grad_clip=0.5, moment_dtype=moments)
    cfg_t = tadamw.AdamConfig(grad_clip=0.5, moment_dtype=moments)
    jp = jax.tree.map(jnp.asarray, p)
    jopt = jadamw.adam_init(jp, cfg_j)
    tp = {"a": torch.from_numpy(p["a"]),
          "b": {"c": weights.to_tensor(p["b"]["c"], "cpu"),
                "d": torch.from_numpy(p["b"]["d"])}}
    topt = tadamw.adam_init(tp, cfg_t)
    for i in range(2):
        g = jax.tree.map(lambda a: (3 * mk(a.shape)).astype(a.dtype), p)
        jp, jopt, jm = jadamw.adam_update(jp, jax.tree.map(jnp.asarray, g),
                                          jopt, cfg_j, 0.5)
        tg = jax.tree.map(lambda a: weights.to_tensor(a, "cpu"), g)
        tp2, topt2, tm = tadamw.adam_update(tp, tg, topt, cfg_t, 0.5)
        assert tp2 is tp and topt2 is topt                   # in place
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < \
            1e-5 * float(jm["grad_norm"])
        assert int(topt["step"]) == int(jopt["step"]) == i + 1
        for got, want in ((tp, jp), (topt["m"], jopt["m"]),
                          (topt["v"], jopt["v"])):
            for a, b in zip(pytree.tree_leaves(got), jax.tree.leaves(want)):
                assert a.dtype == TDT[str(b.dtype)]
                tol = 1e-6 if a.dtype == torch.float32 else 1e-2
                assert _rel(a, b) < tol, _rel(a, b)


def test_warmup_cosine_matches_reference():
    for kw in ({}, {"warmup": 3, "total": 20, "floor": 0.2}):
        for step in (0, 1, 2, 3, 10, 19, 20, 50, 10_000):
            want = float(jschedule.warmup_cosine(step, **kw))
            assert abs(float(warmup_cosine(step, **kw)) - want) < 1e-6
            assert float(warmup_cosine(torch.tensor(step), **kw)) == \
                float(warmup_cosine(step, **kw))


def _states(dtype="float32", grad_accum=None, policy="fused"):
    """The reference's initial train state of qwen3-14b-smoke (cast to
    `dtype`), its jitted step, and the port's copy and step."""
    jcfg, tcfg = jget(ARCH), tget(ARCH)
    if grad_accum is not None:
        jcfg = dataclasses.replace(jcfg, grad_accum=grad_accum)
        tcfg = dataclasses.replace(tcfg, grad_accum=grad_accum)
    js = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0), max_seq=16)
    js = {"params": jax.tree.map(lambda a: a.astype(JDT[dtype]),
                                 js["params"]), "opt": js["opt"]}
    ts = weights.from_jax_train_state(jax.tree.map(np.asarray, js),
                                      device="cpu")
    kw = {"schedule_kwargs": {"warmup": 1, "total": 10}, "policy": policy}
    return (js, jax.jit(jsteps.make_train_step(jcfg, **kw)), ts,
            tsteps.make_train_step(tcfg, **kw))


@pytest.mark.parametrize("policy", ["fused", "tuned"])
def test_three_train_steps_match_reference(policy):
    """Three steps from the reference's state on the same batches (f32):
    losses within 1e-5 each step, lr_scale and grad_norm too, parameters
    within 1e-5 relative L2 (whole tree) after each step."""
    js, jstep, ts, tstep = _states(policy=policy)
    for i in range(3):
        batch = _tokens(seed=10 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, batch)
        assert sorted(tm) == sorted(jm)
        for key in jm:
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-5 * max(abs(float(jm[key])), 1.0), key
        jflat = weights.from_jax_params(jax.tree.map(
            np.asarray, js["params"]), device="cpu")
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(
            pytree.tree_leaves(ts["params"]), pytree.tree_leaves(jflat)))
        den = sum(float((b ** 2).sum()) for b in pytree.tree_leaves(jflat))
        assert (num / den) ** 0.5 < 1e-5
        assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == i + 1


def test_grad_accum_matches_one_batch_and_reference():
    """grad_accum 2 on a batch of 4 rows: the port's metrics (loss, no
    parts) and parameters after one step equal the port's grad_accum 1 on
    the same batch (f32, 1e-5) and the reference's grad_accum 2."""
    batch = _tokens(b=4, seed=21)
    js, jstep, ts2, tstep2 = _states(grad_accum=2)
    _, _, ts1, tstep1 = _states(grad_accum=1)
    js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
    ts2, m2 = tstep2(ts2, batch)
    ts1, m1 = tstep1(ts1, batch)
    assert sorted(m2) == sorted(jm) == ["grad_norm", "loss", "lr_scale"]
    assert sorted(m1) == ["aux", "ce", "grad_norm", "loss", "lr_scale"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m2[key]) - float(m1[key])) < 1e-5 * float(m1[key])
        assert abs(float(m2[key]) - float(jm[key])) < 1e-5 * float(jm[key])
    for a, b in zip(pytree.tree_leaves(ts2["params"]),
                    pytree.tree_leaves(ts1["params"])):
        assert _rel(a, b) < 1e-5


def test_train_chunk_equals_the_step_loop():
    """`make_train_chunk` over three stacked batches: the same state and
    metrics (stacked to (3,)) as three calls of the step, bit for bit."""
    _, _, ts_a, step = _states(policy="fused")
    _, _, ts_b, _ = _states(policy="fused")
    batches = [_tokens(seed=30 + i) for i in range(3)]
    rows = []
    for b in batches:
        ts_a, m = step(ts_a, b)
        rows.append(m)
    ts_b, mc = tengine.make_train_chunk(step)(
        ts_b, tengine.stack_batches(batches))
    for key in rows[0]:
        assert mc[key].shape == (3,)
        assert torch.equal(mc[key], torch.stack([r[key] for r in rows]))
    for a, b in zip(pytree.tree_leaves(ts_a), pytree.tree_leaves(ts_b)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# (j) the train loop
# ----------------------------------------------------------------------------

def _feed(start):
    step = start
    while True:
        yield (step, _tokens(seed=100 + step))
        step += 1


def test_train_loop_resume_equals_uninterrupted(tmp_path):
    """A loop run to step 3 (checkpointed) and a second loop that resumes
    from that checkpoint on a fresh state and runs to 6 log the same
    losses as one loop run 0..6 (f32, bit for bit), and end on the same
    parameters; a SIGTERM during a run stops it with a final checkpoint
    and the handler before the run is put back."""
    _, _, ts, step = _states(policy="tuned")
    kw = dict(checkpoint_every=2, log_every=1)
    whole = TrainLoop(TrainLoopConfig(total_steps=6, checkpoint_dir=str(
        tmp_path / "whole"), **kw), step, ts, _feed(0)).run(start_step=0)
    _, _, ts1, _ = _states(policy="tuned")
    first = TrainLoop(TrainLoopConfig(total_steps=3, checkpoint_dir=str(
        tmp_path / "cut"), **kw), step, ts1, _feed(0)).run(start_step=0)
    _, _, fresh, _ = _states(policy="tuned")
    for leaf in pytree.tree_leaves(fresh):
        leaf.zero_()
    loop = TrainLoop(TrainLoopConfig(total_steps=6, checkpoint_dir=str(
        tmp_path / "cut"), **kw), step, fresh, _feed(3))
    second = loop.run()
    assert first["final_step"] == 3 and second["final_step"] == 6
    assert [m["loss"] for m in first["metrics"] + second["metrics"]] == \
        [m["loss"] for m in whole["metrics"]]
    assert sorted(second) == sorted(["final_step", "preempted",
                                     "wall_seconds", "straggler_events",
                                     "stall", "steps_per_sync", "metrics"])

    before = signal.getsignal(signal.SIGTERM)
    calls = []

    def preempting(state, batch):
        out = step(state, batch)
        calls.append(1)
        if len(calls) == 2:
            _sigterm()
        return out

    _, _, ts3, _ = _states(policy="tuned")
    rep = TrainLoop(TrainLoopConfig(total_steps=6, checkpoint_dir=str(
        tmp_path / "term"), **kw), preempting, ts3, _feed(0)).run(
        start_step=0)
    assert rep["preempted"] and rep["final_step"] == 2
    assert sorted(p.name for p in (tmp_path / "term").glob("step-*")) == \
        ["step-000000002"]
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_loop_async_checkpoints_hold_their_step(tmp_path,
                                                      monkeypatch):
    """On the CPU the step updates the state in place while an async save
    of an earlier step is still being written (the writer is held back
    here until the loop has run on): each step's checkpoint holds that
    step's state bit for bit, and a resume from the middle one logs the
    uninterrupted run's later losses."""
    from repro_torch.checkpoint.manager import CheckpointManager
    write = CheckpointManager._write_step

    def late(self, step, snapshot):
        time.sleep(0.3)
        write(self, step, snapshot)

    monkeypatch.setattr(CheckpointManager, "_write_step", late)
    _, _, ts, step = _states()
    seen = []

    def recording(state, batch):
        state, metrics = step(state, batch)
        seen.append(pytree.tree_map(torch.clone, state))
        return state, metrics

    cfg = TrainLoopConfig(total_steps=3, checkpoint_every=1, log_every=1,
                          checkpoint_dir=str(tmp_path))
    whole = TrainLoop(cfg, recording, ts, _feed(0)).run(start_step=0)
    ckpt = CheckpointManager(tmp_path)
    for i, want in enumerate(seen, 1):
        got = ckpt.restore(i, want)
        for a, b in zip(pytree.tree_leaves(want), pytree.tree_leaves(got)):
            assert torch.equal(a, b), i
    mid = tmp_path / "mid"
    shutil.copytree(tmp_path / "step-000000001", mid / "step-000000001")
    _, _, fresh, _ = _states()
    resumed = TrainLoop(dataclasses.replace(cfg, checkpoint_dir=str(mid)),
                        step, fresh, _feed(1)).run()
    assert [m["loss"] for m in resumed["metrics"]] == \
        [m["loss"] for m in whole["metrics"][1:]]


@pytest.mark.parametrize("name", sorted(FUSED))
def test_unfused_route_under_grad_runs_through_the_function(
        smoke_params, monkeypatch, name):
    """Where the tuning race picked a fused op's composition, `tuned_call`
    under grad runs that composition as the forward of the op's Function
    (its primitive launches carry no gradient): the unfused route is
    taken, the output's grad_fn is the Function's, and the gradients equal
    the fused route's bit for bit (the backward is the same VJP of the
    same saved inputs). A train step under "tuned" reaches no fused op
    (the model's "tuned" forward is the plain product route), so it races
    nothing and takes no composition."""
    from repro_torch.cluster.policy import KernelPolicy
    from repro_torch.configs import registry

    def unfused(kernel, key):
        route = "unfused" if ops.OPS[kernel].fused else "fused"
        return registry.KernelTuneRecord(kernel, key, (), 0.0, route=route)

    monkeypatch.setattr(registry, "get_kernel_tune", unfused)
    _, tfn, fn_cls, kw = FUSED[name]
    pairs = _fused_inputs(name, "float32")
    ct = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tfn(*[t for _, t in pairs], **kw).shape).astype(np.float32))
    grads = []
    for tuned in (True, False):        # the race's composition, the kernel
        xs = [t.clone().requires_grad_() for _, t in pairs]
        pol = KernelPolicy(mode="tuned" if tuned else "fused")
        with tuse(pol):
            out = ops.tuned_call(name, *xs, **kw) if tuned else tfn(*xs, **kw)
        assert type(out.grad_fn).__name__ == fn_cls.__name__ + "Backward"
        assert pol.stats.get("unfused_routes", 0) == tuned
        grads.append(torch.autograd.grad(out, xs, ct))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    pol = KernelPolicy(mode="tuned")
    batch = {k: torch.from_numpy(v) for k, v in _tokens().items()}
    tsteps.make_train_step(tget(ARCH), policy=pol).accumulate(
        smoke_params["float32"][1], batch)
    assert not {"unfused_routes", "tune_hits", "tune_misses"} & set(
        pol.stats), pol.stats


def test_train_loop_chunked_logs_and_checkpoints(tmp_path):
    """steps_per_sync 2 with a train chunk: one host sync a chunk, rows
    with steps_in_chunk, the chunk-safe checkpoint cadence."""
    _, _, ts, step = _states(policy="tuned")
    rep = TrainLoop(TrainLoopConfig(total_steps=5, checkpoint_every=3,
                                    log_every=1, steps_per_sync=2,
                                    checkpoint_dir=str(tmp_path)),
                    step, ts, _feed(0),
                    train_chunk=tengine.make_train_chunk(step)).run()
    assert rep["final_step"] == 5 and rep["steps_per_sync"] == 2
    assert [m["step"] for m in rep["metrics"]] == [2, 4, 5]
    assert [m.get("steps_in_chunk") for m in rep["metrics"]] == [2, 2, None]
    assert rep["stall"]["host_syncs"] == 3
    assert sorted(p.name for p in tmp_path.glob("step-*")) == \
        ["step-000000004", "step-000000005"]


def test_straggler_detector_matches_reference():
    times = [0.1 + 0.001 * (i % 3) for i in range(20)] + [1.5, 0.1, 0.9]
    got, want = StragglerDetector(z=3.0, warmup=5), jloop.StragglerDetector(
        z=3.0, warmup=5)
    flags = [(got.observe(i, t), want.observe(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert got.events == want.events and got.events[0]["step"] == 20
    assert jloop._crossed(3, 5, 2) == jloop._crossed(3, 5, 2) is True


# ----------------------------------------------------------------------------
# (k) TrainProgram, api.train, the CLI, the example
# ----------------------------------------------------------------------------

def test_train_program_matches_reference(tmp_path):
    """TrainProgram(num_steps=3) on qwen3-14b-smoke from the reference's
    initial state (bf16, as the program makes it) on the same stream:
    the report's keys, and the logged losses within 2e-2; the report()
    keys equal (the reference's mesh, the port's device aside)."""
    spec = dict(num_steps=3, batch=2, seq=16, log_every=1)
    jprog = jsession.Cluster(ARCH).compile(jsession.TrainProgram(
        checkpoint_dir=str(tmp_path / "j"), **spec))
    jrep = jprog.run()
    js = jsteps.init_train_state(jget(ARCH), jax.random.PRNGKey(0),
                                 max_seq=16)
    tprog = tsession.Cluster(ARCH, device="cpu").compile(
        tsession.TrainProgram(checkpoint_dir=str(tmp_path / "t"), **spec))
    assert isinstance(tprog, tsession.CompiledTrain) and tprog.chunk is None
    tprog.init_state = lambda seed=None: weights.from_jax_train_state(
        jax.tree.map(np.asarray, js), device="cpu")
    trep = tprog.run()
    assert sorted(trep) == sorted(jrep)
    assert [m["step"] for m in trep["metrics"]] == \
        [m["step"] for m in jrep["metrics"]] == [1, 2, 3]
    for a, b in zip(trep["metrics"], jrep["metrics"]):
        assert sorted(a) == sorted(b)
        assert abs(a["loss"] - b["loss"]) < 2e-2 * b["loss"]
    jr, tr = jprog.report(), tprog.report()
    assert sorted(set(tr) - {"device"}) == sorted(set(jr) - {"mesh"})
    assert sorted(tr["result"]) == sorted(jr["result"])
    assert "params" not in tr["result"]
    assert tr["kind"] == jr["kind"] == "train"


def test_train_program_resume_and_double_buffer(tmp_path):
    """steps_per_sync 2 and the double-buffered feed; a run preempted at
    step 2 and a resume=True run to 4 log the losses of one run to 4 (the
    stream continues at the restored step); the feed's stall report."""
    kw = dict(num_steps=4, batch=2, seq=16, log_every=1, warmup=1,
              double_buffer=True, steps_per_sync=2)
    cluster = tsession.Cluster(ARCH, device="cpu")
    whole = cluster.compile(tsession.TrainProgram(
        checkpoint_dir=str(tmp_path / "w"), **kw)).run()
    assert sorted(whole["feed"]) == ["consumer_wait_s", "hidden_s",
                                     "overlap_pct", "produce_s"]
    one = dict(kw, steps_per_sync=1)
    whole1 = cluster.compile(tsession.TrainProgram(
        checkpoint_dir=str(tmp_path / "w1"), **one)).run()
    cut = cluster.compile(tsession.TrainProgram(
        checkpoint_dir=str(tmp_path / "c"), **one))
    step, calls = cut.step, []

    def preempting(state, batch):
        out = step(state, batch)
        calls.append(1)
        if len(calls) == 2:
            _sigterm()
        return out

    cut.step = preempting
    first = cut.run()
    resumed = cluster.compile(tsession.TrainProgram(
        checkpoint_dir=str(tmp_path / "c"), resume=True, **one)).run()
    assert first["preempted"] and first["final_step"] == 2
    losses = [m["loss"] for m in first["metrics"] + resumed["metrics"]]
    assert losses == [m["loss"] for m in whole1["metrics"]]
    assert [m["loss"] for m in whole["metrics"]][-1] == losses[-1]


def test_api_train_matches_reference_keys(tmp_path):
    """api.train's report keys equal the reference's; `steps_` warns and
    works; a `mesh=` with a model axis above 1 admits every arch under
    its own rules (xlstm too: the plan splits only its vocabulary) and
    then needs a process group, which this process has none of (the
    data axis runs: tests/test_torch_dp.py; the model axis for every
    block kind: tests/test_torch_tp.py; the refusal of a split the step
    does not compute, xlstm under the tponly rules, is pinned there)."""
    kw = dict(num_steps=2, batch=2, seq=16)
    want = japi.train("qwen3-14b", checkpoint_dir=str(tmp_path / "j"), **kw)
    got = tapi.train("qwen3-14b", checkpoint_dir=str(tmp_path / "t"),
                     device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["final_step"] == want["final_step"] == 2
    assert np.isfinite(got["metrics"][-1]["loss"])
    with pytest.deprecated_call():
        rep = tapi.train("qwen3-14b", steps_=1, batch=2, seq=8,
                         checkpoint_dir=str(tmp_path / "alias"),
                         device="cpu")
    assert rep["final_step"] == 1
    with pytest.raises(RuntimeError, match="no process group"):
        tapi.train("xlstm-125m", mesh=MeshSpec((1, 2), ("data", "model")),
                   device="cpu")


def test_cli_and_example_run_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --device cpu --arch qwen3-14b
    --smoke --steps 3` and `examples/train_lm_torch.py --fast` (2 steps,
    small batch) run; a --data-axis that does not divide the ranks (one
    process, no torchrun: one rank) is refused."""
    from repro_torch.launch import train as cli
    rep = cli.main(["--device", "cpu", "--arch", "qwen3-14b", "--smoke",
                    "--steps", "3", "--checkpoint-dir",
                    str(tmp_path / "cli"), "--no-resume"])
    assert rep["final_step"] == 3
    assert "final step 3" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--arch", "qwen3-14b", "--smoke",
                  "--data-axis", "2"])
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_lm_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    rep = train_lm_torch.main(["--fast", "--steps", "2", "--batch", "2",
                               "--seq", "32", "--device", "cpu", "--ckpt",
                               str(tmp_path / "ex")])
    assert rep["final_step"] == 2
