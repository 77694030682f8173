"""Every parameter's gradient of every arch of the registry, the port's
against the reference's, on the CPU.

One case an arch (its smoke config, f32): the MoE block (grok, mixtral),
the recurrent kinds (recurrentgemma's rglru, xlstm's mlstm and slstm),
whisper's encoder-decoder (with its stub frame embeddings), the vision
model's cross block (with image embeddings, its gates opened) and the
dense decoders. The same parameters (the port's seeded draw, stacked
into the reference's layout by the plan's keys (`steps.param_plan_keys`),
rescaled to the true fan-in and the cross gates opened:
`tests/torch_parity.py`) and
the same batch go through `jax.value_and_grad` of the reference's loss
(compiled without XLA's costly backend passes: `FAST_COMPILE`)
and through the port's train step's `accumulate` under "fused" (its
autograd Functions on their plain routes here); the reference runs its
default "tuned" route, which calls no Pallas kernel: the same function.

Tolerance: the loss within 1e-5 relative; every leaf's gradient within
1e-5 relative L2 (sum order alone parts them), none all zero unless the
reference's is too. xlstm within 7e-5 (`TOL`; the largest leaf's error
is 6.2e-5, the input gate's bias): its f32 gradients part from a float64
run by 2.0e-5 in the port and 4.3e-5 in the reference
(`test_xlstm_f32_gradients_are_within_the_references_error`), so the two
packages part by as much as the reference's own error. An f32 run of
the port takes the mLSTM heads in float64 (`blocks.mlstm_block_apply`).
`test_xlstm_gradient_error_is_one_cancelling_row` pins the cause: in
the mLSTM layer whose backward amplifies most (layer 5), one head output
row, about 160 times below the median row in rms, is a sum whose terms
cancel, and the per-head rms norm after it scales that row to unit size
and its gradient by 1 / rms. The reference's f32 sums leave that row
4.6e-6 off relative; the port's float64 heads leave it 1.8e-6 off (the
rounding of the layer's input to f32 alone).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import torch_parity
from repro.cluster.policy import use_policy as juse
from repro.configs import get as jget
from repro.models import blocks as jblocks
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.configs import ARCHS
from repro_torch.configs import get as tget
from repro_torch.kernels import ref as kref
from repro_torch.models import attention, blocks, layers
from repro_torch.models import steps as tsteps

B, S = 2, 16
TOL = {"xlstm-125m": 7e-5}


def _batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


_GRADS = {}


def _grads(name):
    """(reference loss, reference gradients, port loss, port gradients,
    the port's parameters, the batch) of a smoke arch, in f32."""
    if name not in _GRADS:
        jcfg, tcfg = jget(name), tget(name)
        drawn = tsteps.init_params(tcfg, 0, device="cpu")
        jp, tp = torch_parity.load(torch_parity.true_fan_in(
            torch_parity.open_gates(jax.tree.map(
                jnp.asarray, torch_parity.reference_tree(tcfg, drawn)))),
            jnp.float32)
        batch = _batch(tcfg)
        jb = jax.tree.map(jnp.asarray, batch)
        with juse("tuned"):
            step = jax.jit(jax.value_and_grad(
                lambda p, b: jsteps.loss_fn(jcfg, p, b), has_aux=True))
            (jloss, _), jg = step.lower(jp, jb).compile(
                compiler_options=torch_parity.FAST_COMPILE)(jp, jb)
        jg = weights.from_jax_params(jax.tree.map(np.asarray, jg),
                                     device="cpu")
        loss, _, tg = tsteps.make_train_step(
            tcfg, policy="fused").accumulate(
                tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        _GRADS[name] = jloss, jg, loss, tg, tp, batch
    return _GRADS[name]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_grads_match_reference_for_every_arch(arch):
    jloss, jg, loss, tg, _, _ = _grads(arch + "-smoke")
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    flat = pytree.tree_flatten_with_path(tg)[0]
    assert len(flat) == len(pytree.tree_leaves(jg))

    tol = TOL.get(arch, 1e-5)

    def check(path, got, want):
        key = pytree.keystr(path)
        g, w = got.numpy(), want.numpy()
        assert got.dtype == torch.float32 and np.isfinite(g).all(), key
        wn = np.linalg.norm(w)
        if wn == 0:
            assert np.linalg.norm(g) == 0, key
            return
        assert np.abs(g).max() > 0, key
        rel = np.linalg.norm(g - w) / wn
        assert rel < tol, (key, rel)

    pytree.tree_map_with_path(check, tg, jg)


def _rel_l2(got, want) -> dict:
    """{leaf: relative L2 error} of two gradient trees, against `want`
    (float64), leaves whose `want` is all zero left out."""
    out = {}

    def one(path, g, w):
        w = w.double()
        if w.norm() > 0:
            out[pytree.keystr(path)] = float((g.double() - w).norm()
                                             / w.norm())

    pytree.tree_map_with_path(one, got, want)
    return out


def test_xlstm_f32_gradients_are_within_the_references_error(monkeypatch):
    """xlstm-125m-smoke's f32 gradients (the test above's parameters and
    batch) against a float64 run of the port (the `F32` constant of the
    model modules set to float64, the parameters cast): the port's worst
    leaf within 3.6e-5 relative L2 and below the reference's own worst
    leaf against the same float64 run."""
    name = "xlstm-125m-smoke"
    _, jg, _, tg, tp, batch = _grads(name)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with monkeypatch.context() as m:
        for mod in (blocks, layers, attention, tsteps, kref):
            m.setattr(mod, "F32", torch.float64)
        _, _, g64 = tsteps.make_train_step(
            tget(name), policy="fused").accumulate(
                pytree.tree_map(lambda t: t.double(), tp), tb)
    port, ref = _rel_l2(tg, g64), _rel_l2(jg, g64)
    assert sorted(port) == sorted(ref)
    assert max(port.values()) < 3.6e-5, max(port.items(), key=lambda i: i[1])
    assert max(port.values()) < max(ref.values())


def _mlstm_heads_ref(jcfg, p, x):
    """The reference's mLSTM head outputs (B, S, H, hd) of one layer, its
    own `_mlstm_qkvif` and `_mlstm_chunk` scanned as its block scans
    them (jitted, f32)."""
    B, S, _ = x.shape
    H, hd, c = jcfg.n_heads, jcfg.hd, min(jcfg.attn_chunk, x.shape[1])

    def run(p, x):
        _, q, k, v, li, lf = jblocks._mlstm_qkvif(jcfg, p, x)

        def step(carry, blk):
            h, *carry = jblocks._mlstm_chunk(*blk, *carry, hd ** -0.5)
            return tuple(carry), h

        split = lambda a: jnp.moveaxis(
            a.reshape(B, S // c, c, *a.shape[2:]), 1, 0)
        init = (jnp.zeros((B, H, hd, hd)), jnp.zeros((B, H, hd)),
                jnp.full((B, H), -1e30))
        _, hs = jax.lax.scan(step, init, tuple(
            split(a) for a in (q, k, v, li, lf)))
        return jnp.moveaxis(hs, 0, 1).reshape(B, S, H, hd)

    return np.asarray(jax.jit(run)(p, x), np.float64)


def test_xlstm_gradient_error_is_one_cancelling_row(monkeypatch):
    """Layer 5 of xlstm-125m-smoke (the test above's parameters and
    batch; its input from a float64 run of the port): the reference's
    mLSTM head outputs are within 1e-6 relative L2 of the port's float64
    run, and its largest relative error on a row of head outputs (a batch
    row, position and head) is 5-50 times that, on one of the rows whose
    rms is below 1/100 of the median row's: the row whose error the
    per-head rms norm scales up. The port's f32 run, whose heads are
    taken in float64, is within 1e-7 (its rounding to f32), and its worst
    row, one of those small rows too, is off by less than half the
    reference's (the rounding of the layer's input to f32 alone)."""
    name, layer = "xlstm-125m-smoke", 5
    tcfg, jcfg = tget(name), jget(name)
    drawn = tsteps.init_params(tcfg, 0, device="cpu")
    _, tp = torch_parity.load(torch_parity.true_fan_in(
        torch_parity.open_gates(jax.tree.map(
            jnp.asarray, torch_parity.reference_tree(tcfg, drawn)))),
        jnp.float32)
    tokens = torch.from_numpy(_batch(tcfg)["tokens"])
    ctx = {"positions": torch.arange(S).expand(B, S), "rope": True,
           "cross_embeds": None, "max_seq": S}
    heads = {}
    out = blocks._mlstm_out

    def keep(cfg, p, x, h, gate, *axis):
        heads[h.dtype] = h.detach().double()
        return out(cfg, p, x, h, gate, *axis)

    kinds = tsteps.layer_kinds(tcfg)
    with torch.no_grad(), monkeypatch.context() as m:
        for mod in (blocks, layers, attention, tsteps, kref):
            m.setattr(mod, "F32", torch.float64)
        p64 = pytree.tree_map(lambda t: t.double(), tp)
        x = p64["tok_embed"][tokens.long()]
        for kind, p in zip(kinds[:layer], p64["blocks"][:layer]):
            x, _ = blocks.BLOCKS[kind]["apply"](tcfg, p, x, ctx)
        m.setattr(blocks, "_mlstm_out", keep)
        blocks.BLOCKS["mlstm"]["apply"](tcfg, p64["blocks"][layer], x, ctx)
    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(blocks, "_mlstm_out", keep)
        blocks.BLOCKS["mlstm"]["apply"](tcfg, tp["blocks"][layer],
                                        x.float(), ctx)
    want = heads[torch.float64].numpy()
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp["blocks"][layer].items()}
    got = {"port": heads[torch.float32].numpy(),
           "reference": _mlstm_heads_ref(jcfg, jp, jnp.asarray(
               x.float().numpy()))}
    rms = np.sqrt((want ** 2).mean(-1))
    small = rms < np.median(rms) / 100
    assert small.any()
    whole, rows = {}, {}
    for who, h in got.items():
        whole[who] = np.linalg.norm(h - want) / np.linalg.norm(want)
        rows[who] = (np.linalg.norm(h - want, axis=-1)
                     / np.linalg.norm(want, axis=-1))
        worst = np.unravel_index(rows[who].argmax(), rows[who].shape)
        assert small[worst], (who, rms[worst], np.median(rms))
    ref = "reference"
    assert whole[ref] < 1e-6, whole
    assert 5 * whole[ref] < rows[ref].max() < 50 * whole[ref], \
        (rows[ref].max(), whole[ref])
    assert whole["port"] < 1e-7, whole
    assert rows["port"].max() < 0.5 * rows[ref].max(), \
        (rows["port"].max(), rows[ref].max())
