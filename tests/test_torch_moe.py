"""repro_torch's MoE block ("attn_moe") against the reference, at smoke size.

Configs: `grok-1-314b-smoke` (no window) and `mixtral-8x7b-smoke` (a
window of 16, so its decode caches roll once max_seq passes 16 and its
24-token prefill takes the banded schedule), each with global and with
per-row (`moe_local_dispatch`) dispatch, under "tuned" and "fused". The
reference parameters are loaded with `weights.from_jax_params` (the f32
router and the stacked (E, d, f) experts carry across as they are).

Tolerances: forward logits in f32 within 1e-4 and the aux loss within
1e-5; `moe_apply` alone in f32 within 1e-5. In bf16, 99.5% of the logits
within 5e-2 absolute + relative (`test_torch_model.py` holds a dense
model's every logit so): a bf16 rounding near a router tie or a capacity
edge sends a token to another expert, and the few logits that token
touches part further (5 of 6,144 of mixtral-smoke's per-row dispatch, by
up to 0.074).
Greedy tokens (prefill, decode, the session and the batch program) must
be equal; they are compared with parameters and caches cast to f32 on
both sides, where no argmax sits near a tie and no router top-k near a
tie. At decode T = B tokens compete for a capacity of
max(int(2 * B * 1.25 / 4), 1) slots an expert, so tokens are dropped, as
in the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.policy import use_policy as juse
from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeProgram as JServe
from repro.cluster.session import ServeSessionProgram as JSession
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeProgram as TServe
from repro_torch.cluster.session import ServeSessionProgram as TSession
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import steps as tsteps

ARCHS = ["grok-1-314b-smoke", "mixtral-8x7b-smoke"]
POLICIES = ["tuned", "fused"]


def _cfgs(name, local):
    return (dataclasses.replace(jreg.get(name), moe_local_dispatch=local),
            dataclasses.replace(treg.get(name), moe_local_dispatch=local))


def _params(jcfg, dtype=None):
    jp = jsteps.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, weights.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _f32(t) -> np.ndarray:
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module", params=[(a, loc) for a in ARCHS
                                        for loc in (False, True)],
                ids=lambda p: f"{p[0].split('-')[0]}-"
                              f"{'local' if p[1] else 'global'}")
def model(request):
    jcfg, tcfg = _cfgs(*request.param)
    return jcfg, tcfg, _params(jcfg), _params(jcfg, jnp.float32)


def test_moe_params_carry_across(model):
    jcfg, tcfg, (jp, tp), _ = model
    moe = tp["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["w_gate"].shape) == (tcfg.n_experts, tcfg.d_model,
                                          tcfg.d_ff)
    assert moe["w_down"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _f32(moe["w_up"]),
        np.asarray(jp["blocks"]["sub0"]["moe"]["w_up"][0], np.float32))
    specs = tsteps.param_specs(tcfg)
    assert tcfg.n_params() == jcfg.n_params()
    assert len(specs["blocks"]) == tcfg.n_layers


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_forward_logits_and_aux(model, policy):
    jcfg, tcfg, (jp, tp), (jp32, tp32) = model
    tokens = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)
    with juse(policy):
        jh, jaux = jsteps.forward(jcfg, jp32, jnp.asarray(tokens))
        jl = jnp.einsum("bsd,dv->bsv", jh, jp32["unembed"],
                        preferred_element_type=jnp.float32)
    with tuse(policy):
        th, taux = tsteps.forward(tcfg, tp32, torch.from_numpy(tokens))
        tl = tsteps.logits(tp32, th)
    np.testing.assert_allclose(_f32(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    assert float(taux) > 0
    with juse(policy):
        jh, _ = jsteps.forward(jcfg, jp, jnp.asarray(tokens))
        jl = np.asarray(jnp.einsum("bsd,dv->bsv", jh, jp["unembed"],
                                   preferred_element_type=jnp.float32))
    with tuse(policy):
        th, _ = tsteps.forward(tcfg, tp, torch.from_numpy(tokens))
        tl = _f32(tsteps.logits(tp, th))
    assert th.dtype == torch.bfloat16
    assert np.mean(np.abs(tl - jl) <= 5e-2 + 5e-2 * np.abs(jl)) >= 0.995


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_prefill_tokens_f32(model, policy):
    """S = 24: three chunks of 8, so grok takes the masked schedule and
    mixtral (window 16 < 24) the banded one, on both sides."""
    jcfg, tcfg, _, (jp, tp) = model
    tokens = np.random.default_rng(2).integers(0, 256, (3, 24)).astype(
        np.int32)
    want = jsteps.make_prefill_step(jcfg, policy=policy)(
        jp, {"tokens": jnp.asarray(tokens)})
    got = tsteps.make_prefill_step(tcfg, policy=policy)(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decode_both(jcfg, tcfg, jp, tp, policy, *, L=32, steps=26):
    """Feed 3 slots a 4-token prompt at per-slot positions, then decode
    greedily past the window: mixtral's cache holds `decode_cache_len`
    = 16 rows and rolls (every position from 16 on wraps)."""
    B = 3
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (B, 4)).astype(np.int32)
    offs = np.array([0, 2, 5])
    clen = tsteps.decode_cache_len(tcfg, L)
    assert clen == jsteps.decode_cache_len(jcfg, L)
    jc = jax.tree.map(lambda c: c.astype(jnp.float32),
                      jsteps.init_cache(jcfg, B, clen))
    tc = {k: v.float() for k, v in
          tsteps.init_cache(tcfg, B, clen, device="cpu").items()}
    jstep = jax.jit(jsteps.make_decode_step(jcfg, max_seq=L, policy=policy))
    tstep = tsteps.make_decode_step(tcfg, max_seq=L, policy=policy)
    jtok = jnp.asarray(prompt[:, :1])
    ttok = torch.from_numpy(prompt[:, :1])
    jout, tout = [], []
    for t in range(steps):
        pos = offs + t
        if t < prompt.shape[1]:
            jtok = jnp.asarray(prompt[:, t:t + 1])
            ttok = torch.from_numpy(prompt[:, t:t + 1])
        jc, jtok = jstep(jp, jc, {"tokens": jtok,
                                  "pos": jnp.asarray(pos, jnp.int32)})
        tc, ttok = tstep(tp, tc, {"tokens": ttok,
                                  "pos": torch.from_numpy(pos)})
        jout.append(np.asarray(jtok)[:, 0])
        tout.append(ttok.numpy()[:, 0])
    return np.stack(jout, 1), np.stack(tout, 1), jc, tc, clen


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_decode_tokens_f32(model, policy):
    jcfg, tcfg, _, (jp, tp) = model
    jt, tt, jc, tc, clen = _decode_both(jcfg, tcfg, jp, tp, policy)
    np.testing.assert_array_equal(tt, jt)
    assert clen == (16 if tcfg.window else 32)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            _f32(tc[key]), np.asarray(jc["blocks"]["sub0"][key]),
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_moe_apply_drops_over_capacity(local):
    """`moe_apply` alone with a capacity factor of 0.5: some (token, k)
    slots land past their expert's capacity and are dropped, on both
    sides alike (f32, 1e-5)."""
    jcfg, tcfg = _cfgs("mixtral-8x7b-smoke", local)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax.tree.map(
        lambda a: a[0], jsteps.init_params(
            jcfg, jax.random.PRNGKey(1))["blocks"]["sub0"]["moe"]))
    tp = {k: weights.to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 10, 64)).astype(
        np.float32)
    jy, jaux = jblocks.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, taux = tblocks.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    _, _, top_e = tblocks._route(tcfg, tp, torch.from_numpy(x))
    T = 10 if local else 20
    C = max(int(2 * T * 0.5 / 4), 1)
    e_flat = top_e.reshape(2, -1) if local else top_e.reshape(-1)
    _, keep = tblocks._slots(e_flat, 4, C)
    assert not keep.all() and keep.any()


def test_rolling_cache_wraps_like_the_reference():
    """`update_cache` and `decode_attention` with `rolling=True` on a
    6-row cache, per-slot positions running from 0 to 14: the rows
    written and the attention output equal the reference's at every
    step, before, at and past the wrap (f32, 1e-5)."""
    rng = np.random.default_rng(6)
    B, sc, kv, hd, H = 2, 6, 2, 8, 4
    offs = np.array([0, 3])
    jk = jv = jnp.zeros((B, sc, kv, hd), jnp.float32)
    tk, tv = torch.zeros(B, sc, kv, hd), torch.zeros(B, sc, kv, hd)
    for t in range(12):
        pos = offs + t
        q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, 1, H, hd), (B, 1, kv, hd), (B, 1, kv, hd)))
        jk, jv = jattn.update_cache(jk, jv, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), rolling=True)
        tk, tv = tattn.update_cache(tk, tv, torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(pos), rolling=True)
        want = jattn.decode_attention(jnp.asarray(q), jk, jv,
                                      jnp.asarray(pos + 1), n_kv=kv,
                                      window=sc, rolling=True)
        got = tattn.decode_attention(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(pos + 1), n_kv=kv,
                                     window=sc, rolling=True)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# the session (private rolling caches) and the batch program
# ----------------------------------------------------------------------------

COMMON = dict(slots=4, max_seq=40, max_prompt=12, chunk=4)


def _script():
    rng = np.random.default_rng(8)
    return [(rng.integers(1, 200, int(rng.integers(2, 12))).astype(np.int32),
             int(rng.integers(6, 22))) for _ in range(7)]


def _f32_params(arch):
    jp = JCluster(arch).compile(JSession(preempt=False, **COMMON)).init_params()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, weights.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _serve(prog, p, reqs):
    sess = prog.open(params=p)
    cache = sess.state["cache"]
    if isinstance(next(iter(cache.values())), torch.Tensor):
        sess.state["cache"] = {k: v.float() for k, v in cache.items()}
    else:
        sess.state = dict(sess.state, cache=jax.tree.map(
            lambda c: c.astype(jnp.float32), cache))
    handles = [sess.submit(prompt, n) for prompt, n in reqs]
    stats = sess.drain()
    return [h.result() for h in handles], stats


@pytest.mark.parametrize("arch,paged", [("mixtral-8x7b-smoke", False),
                                        ("grok-1-314b-smoke", True)],
                         ids=["mixtral-private", "grok-paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_moe_session_matches_reference(arch, paged, policy):
    """Requests of up to 11 + 21 tokens through ServeSessionProgram: on
    mixtral (max_seq 40 > window 16) every slot's private cache rolls;
    grok pages its K/V. Tokens, and the pool counters, equal."""
    jp, tp = _f32_params(arch)
    extra = dict(paged=True, page_size=4) if paged else {}
    jc, tc = JCluster(arch), TCluster(arch, device="cpu")
    with jc.policy(policy):
        jprog = jc.compile(JSession(preempt=False, **COMMON, **extra))
    with tc.policy(policy):
        tprog = tc.compile(TSession(**COMMON, **extra))
    reqs = _script()
    jtoks, jst = _serve(jprog, jp, reqs)
    ttoks, tst = _serve(tprog, tp, reqs)
    for (prompt, n), a, b in zip(reqs, jtoks, ttoks):
        assert b.size == n
        np.testing.assert_array_equal(b, a)
    for key in ("requests_done", "emitted_total", "occupancy_pct"):
        assert tst[key] == jst[key], key
    if paged:
        assert tst["kv"] == {k: jst["kv"][k] for k in tst["kv"]}


def test_windowed_arch_refuses_the_paged_session():
    """Mixtral keeps private rolling caches: its paged cache specs raise
    in both packages."""
    jcfg, tcfg = _cfgs("mixtral-8x7b-smoke", False)
    with pytest.raises(ValueError):
        jsteps.paged_cache_specs(jcfg, 4, 40, n_pages=9, page_size=4)
    with pytest.raises(ValueError, match="pageable"):
        tsteps.paged_cache_specs(tcfg, 4, 40, n_pages=9, page_size=4)


@pytest.mark.parametrize("chunk", [1, 4])
def test_mixtral_serve_program_matches_reference(chunk, monkeypatch):
    """ServeProgram(batch=4, max_seq=40, max_new=24) with a 6-token
    prompt: positions run to 29, past the window of 16, so the private
    caches roll; tokens and emitted counts equal the reference's."""
    arch = "mixtral-8x7b-smoke"
    jp, tp = _f32_params(arch)
    jinit, tinit = jsteps.init_cache, tsteps.init_cache
    monkeypatch.setattr(jsteps, "init_cache", lambda *a, **k: jax.tree.map(
        lambda c: c.astype(jnp.float32), jinit(*a, **k)))
    monkeypatch.setattr(tsteps, "init_cache", lambda *a, **k: {
        n: c.float() for n, c in tinit(*a, **k).items()})
    spec = dict(batch=4, max_seq=40, max_new=24, chunk=chunk)
    prompt = np.random.default_rng(9).integers(1, 200, (4, 6))
    want = JCluster(arch).compile(JServe(**spec)).run(params=jp,
                                                      prompt=prompt)
    prog = TCluster(arch, device="cpu").compile(TServe(**spec))
    got = prog.run(params=tp, prompt=prompt)
    assert prog.cache["k"].shape[2] == 16
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["stats"]["emitted_per_slot"] == \
        want["stats"]["emitted_per_slot"]
