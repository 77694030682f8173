"""repro_torch's recurrent archs against the reference, at smoke size.

`recurrentgemma-9b-smoke` (rglru, rglru, local_attn; a window of 16 and
the geglu MLP) and `xlstm-125m-smoke` (mlstm x 3, slstm), 8 and 6
layers: each block kind alone, the whole model's forward, prefill,
decode, `ServeProgram` and the continuous-batching session, with the
reference's parameters loaded through `weights.from_jax_params`; and the
decode cache's layout, a group of leaves for each kind of layer.

Tolerances: f32 block outputs and f32 logits within 1e-4 absolute +
relative; a block's prefill against its own step-by-step decode within
1e-4 (f32; the decode starts the stabiliser m at 0 and the prefill at
-1e30, as the reference's do, and the two differ only where the
normaliser's floor binds); bf16 logits: 99.5% within 5e-2 absolute +
relative (`test_torch_model.py` holds a dense model so). The attention
weights are rescaled to their true fan-in in both packages
(`torch_parity.true_fan_in`): drawn as `ParamSpec` draws them, without a
qk-norm, each softmax picks one key and a one-ulp sum-order difference
flips which (bf16 logits then part by up to 5.8). Greedy tokens
(prefill, decode, `ServeProgram` at chunk 1 and 4 with a prompt, the
session) must be equal; they are compared with parameters and caches
cast to f32 on both sides, where no argmax sits near a tie.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
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
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeProgram as TServe
from repro_torch.cluster.session import ServeSessionProgram as TSession
from repro_torch.configs import registry as treg
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import steps as tsteps
from torch_parity import (decode_both, f32, params, port_layer, ref_layer,
                          serve, session_params)

ARCHS = ["recurrentgemma-9b-smoke", "xlstm-125m-smoke"]
POLICIES = ["tuned", "fused"]
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


@pytest.fixture(scope="module", params=ARCHS,
                ids=lambda a: a.split("-")[0])
def model(request):
    jcfg, tcfg = jreg.get(request.param), treg.get(request.param)
    return jcfg, tcfg, params(jcfg), params(jcfg, jnp.float32)


def test_recurrent_params_carry_across(model):
    jcfg, tcfg, (jp, tp), _ = model
    assert tcfg.n_params() == jcfg.n_params()
    assert len(tp["blocks"]) == tcfg.n_layers
    kinds = tsteps.layer_kinds(tcfg)
    first = kinds.index(jcfg.pattern[0])
    p0 = tp["blocks"][first]
    if "lam" in p0:
        assert p0["lam"].dtype == torch.float32
        np.testing.assert_array_equal(
            f32(p0["w_ra"]), np.asarray(jp["blocks"]["sub0"]["w_ra"][0],
                                        np.float32))
    else:
        assert p0["w_i"].dtype == torch.float32
        np.testing.assert_array_equal(
            f32(p0["w_up"]), np.asarray(jp["blocks"]["sub0"]["w_up"][0],
                                        np.float32))


def test_cache_groups_a_kind_of_layer(model):
    """One group of leaves a kind, named "<kind>.<leaf>", the kind's
    layers stacked on axis 0 and the batch on axis 1; every layer's
    leaves have the shapes and dtypes of the reference's."""
    jcfg, tcfg, _, _ = model
    B, clen = 3, tsteps.decode_cache_len(tcfg, 40)
    specs = tsteps.cache_specs(tcfg, B, clen)
    kinds = tsteps.layer_kinds(tcfg)
    groups = tsteps.cache_groups(tcfg)
    assert [g[1] for g in groups] == list(dict.fromkeys(kinds))
    for prefix, kind, layers in groups:
        assert prefix == kind + "."
        assert [kinds[i] for i in layers] == [kind] * len(layers)
        for key in (k for k in specs if k.startswith(prefix)):
            assert specs[key].shape[:2] == (len(layers), B)
    jc = jsteps.init_cache(jcfg, B, clen)
    tc = tsteps.init_cache(tcfg, B, clen, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: s.shape for k, s in specs.items()}
    for i in range(tcfg.n_layers):
        want, got = ref_layer(jcfg, jc, i), port_layer(tcfg, tc, i)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()}


@pytest.mark.parametrize("arch", ["qwen3-14b-smoke", "whisper-small-smoke",
                                  "mixtral-8x7b-smoke"])
def test_single_kind_archs_keep_their_cache_keys(arch):
    """A single-kind arch keeps one group without a prefix: the keys and
    shapes it had before the layout took a group a kind."""
    cfg = treg.get(arch)
    clen = tsteps.decode_cache_len(cfg, 40)
    specs = tsteps.cache_specs(cfg, 4, clen)
    one = tblocks.BLOCKS[tsteps.layer_kinds(cfg)[0]]["cache"](cfg, 4, clen)
    assert tsteps.cache_groups(cfg) == [
        ("", tsteps.layer_kinds(cfg)[0], list(range(cfg.n_layers)))]
    assert {k: s.shape for k, s in specs.items()} == \
        {k: (cfg.n_layers, *s.shape) for k, s in one.items()}
    assert set(specs) == ({"self_k", "self_v", "cross_k", "cross_v"}
                          if cfg.family == "encdec" else {"k", "v"})


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_geglu_matches_reference(dtype):
    """`apply_ffn(kind="geglu")`: tanh gelu in f32 on the rounded gate
    product. f32 within 1e-5; bf16 within 2e-2 (one rounding of a
    product summed in another order)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    jw = {k: jnp.asarray(v, dtype) for k, v in w.items()}
    tw = {k: weights.to_tensor(np.asarray(v), "cpu") for k, v in jw.items()}
    want = jlayers.apply_ffn(jw, jnp.asarray(x, dtype), kind="geglu")
    got = tlayers.apply_ffn(tw, weights.to_tensor(
        np.asarray(jnp.asarray(x, dtype)), "cpu"), kind="geglu")
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    assert set(tlayers.ffn_specs(64, 96, kind="geglu")) == set(w)


def _block(arch, kind):
    """One layer of `kind` from the arch's f32 reference parameters, in
    both packages."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    i = tsteps.layer_kinds(tcfg).index(kind)
    jp, tp = params(jcfg, jnp.float32)
    return jcfg, tcfg, ref_layer(jcfg, jp, i), tp["blocks"][i]


KINDS = [("recurrentgemma-9b-smoke", "rglru"),
         ("recurrentgemma-9b-smoke", "local_attn"),
         ("xlstm-125m-smoke", "mlstm"), ("xlstm-125m-smoke", "slstm")]


@pytest.mark.parametrize("arch,kind", KINDS, ids=[k for _, k in KINDS])
@pytest.mark.parametrize("policy", POLICIES)
def test_block_apply_matches_reference(arch, kind, policy):
    """Each kind's full-sequence apply alone, f32, S = 24 (local_attn: a
    window of 16 < 24 and three chunks of 8, the banded schedule; mlstm:
    three chunks carried), within 1e-4."""
    jcfg, tcfg, jp, tp = _block(arch, kind)
    x = np.random.default_rng(7).standard_normal((2, 24, 64)).astype(
        np.float32)
    ctx_j = {"positions": jnp.broadcast_to(jnp.arange(24), (2, 24)),
             "max_seq": 24}
    ctx_t = {"positions": torch.arange(24).expand(2, 24), "max_seq": 24}
    with juse(policy):
        want, _ = jblocks.BLOCKS[kind]["apply"](jcfg, jp, jnp.asarray(x),
                                                ctx_j)
    with tuse(policy):
        got, _ = tblocks.BLOCKS[kind]["apply"](tcfg, tp, torch.from_numpy(x),
                                               ctx_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,kind", KINDS, ids=[k for _, k in KINDS])
def test_block_prefill_equals_its_decode_loop(arch, kind):
    """The port's prefill of one block against its own decode, a token a
    step from a zero cache (local_attn: a 16-row cache that rolls past
    position 16), f32, 1e-4; the decode writes its state in place."""
    _, cfg, _, p = _block(arch, kind)
    B, S = 2, 24
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, 64)).astype(np.float32))
    full, _ = tblocks.BLOCKS[kind]["apply"](
        cfg, p, x, {"positions": torch.arange(S).expand(B, S),
                    "max_seq": S})
    cache = {k: torch.zeros(s.shape, dtype=F32)
             for k, s in tblocks.BLOCKS[kind]["cache"](cfg, B, S).items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    outs = []
    for t in range(S):
        o, ret = tblocks.BLOCKS[kind]["decode"](
            cfg, p, x[:, t:t + 1], cache, t,
            {"positions": torch.full((B, 1), t), "max_seq": S})
        outs.append(o)
        assert {k: v.data_ptr() for k, v in ret.items()} == ptrs
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)
    assert any(bool(v.abs().sum() > 0) for v in cache.values())


def test_linear_scan_multiplies_without_underflow():
    """h_t = a_t h_(t-1) + b_t over 4,096 steps with a = 0.1: the sum of
    log a reaches -9,431, whose exponential is 0 in f32, while every h
    stays near 1/0.9. The doubling scan equals the step-by-step loop
    (1e-6)."""
    rng = np.random.default_rng(9)
    a = torch.full((2, 4096, 3), 0.1)
    b = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 4096, 3)).astype(
        np.float32))
    want = torch.empty_like(b)
    h = torch.zeros(2, 3)
    for t in range(4096):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = tblocks.linear_scan(a.clone(), b.clone())
    assert float(torch.log(a).sum(1).min()) < -9000
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_recurrent_forward_logits(model, policy):
    """f32 logits within 1e-4; bf16: 99.5% within 5e-2 of the reference
    run op by op (`jax.disable_jit`), which rounds every op's result to
    bf16 as the port does. Jitted, XLA keeps some fused elementwise chains
    in f32, and on xlstm the jitted reference parts from its own op-by-op
    run by as much: 1.4% of its logits lie outside 5e-2 of it
    (recurrentgemma 0.05%, qwen3-14b-smoke none)."""
    jcfg, tcfg, (jp, tp), (jp32, tp32) = model
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(
        np.int32)
    for (j, t), bf16 in (((jp32, tp32), False), ((jp, tp), True)):
        with juse(policy), jax.disable_jit(bf16):
            jh, _ = jsteps.forward(jcfg, j, jnp.asarray(tokens))
            jl = np.asarray(jnp.einsum("bsd,dv->bsv", jh, j["unembed"],
                                       preferred_element_type=jnp.float32))
        with tuse(policy):
            th, _ = tsteps.forward(tcfg, t, torch.from_numpy(tokens))
            tl = f32(tsteps.logits(t, th))
        if bf16:
            assert th.dtype == torch.bfloat16
            assert np.mean(np.abs(tl - jl) <= 5e-2 + 5e-2 * np.abs(jl)) \
                >= 0.995
        else:
            np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_recurrent_prefill_tokens_f32(model, policy):
    """S = 24: recurrentgemma's local_attn takes the banded schedule
    (window 16), mlstm three chunks of 8."""
    jcfg, tcfg, _, (jp, tp) = model
    tokens = np.random.default_rng(2).integers(0, 256, (3, 24)).astype(
        np.int32)
    want = jsteps.make_prefill_step(jcfg, policy=policy)(
        jp, {"tokens": jnp.asarray(tokens)})
    got = tsteps.make_prefill_step(tcfg, policy=policy)(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", POLICIES)
def test_recurrent_decode_tokens_and_state_f32(model, policy):
    """3 slots at per-slot positions, 22 steps past a 4-token prompt
    (recurrentgemma's 16-row local_attn caches roll): tokens equal, and
    every layer's state (h, conv; C, n, m; c, n, m, h; k, v) within
    1e-4."""
    jcfg, tcfg, _, (jp, tp) = model
    jt, tt, jc, tc = decode_both(jcfg, tcfg, jp, tp, policy, L=32, steps=22)
    np.testing.assert_array_equal(tt, jt)
    for i in range(tcfg.n_layers):
        want, got = ref_layer(jcfg, jc, i), port_layer(tcfg, tc, i)
        for k in want:
            np.testing.assert_allclose(f32(got[k]), np.asarray(want[k]),
                                       **TOL, err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
@pytest.mark.parametrize("chunk", [1, 4])
def test_recurrent_serve_program_matches_reference(arch, chunk,
                                                   monkeypatch):
    """ServeProgram(batch=3, max_seq=40, max_new=20) with a 6-token
    prompt (recurrentgemma's local_attn caches roll past 16): tokens and
    emitted counts equal the reference's."""
    jp, tp = session_params(arch, COMMON)
    jinit, tinit = jsteps.init_cache, tsteps.init_cache
    monkeypatch.setattr(jsteps, "init_cache", lambda *a, **k: jax.tree.map(
        lambda c: c.astype(jnp.float32), jinit(*a, **k)))
    monkeypatch.setattr(tsteps, "init_cache", lambda *a, **k: {
        n: c.float() for n, c in tinit(*a, **k).items()})
    spec = dict(batch=3, max_seq=40, max_new=20, chunk=chunk)
    prompt = np.random.default_rng(9).integers(1, 200, (3, 6))
    want = JCluster(arch).compile(JServe(**spec)).run(params=jp,
                                                      prompt=prompt)
    got = TCluster(arch, device="cpu").compile(TServe(**spec)).run(
        params=tp, prompt=prompt)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["stats"]["emitted_per_slot"] == \
        want["stats"]["emitted_per_slot"]


COMMON = dict(slots=3, max_seq=40, max_prompt=10, chunk=4)


def _script(n=5, seed=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 200, int(rng.integers(2, 10))).astype(np.int32),
             int(rng.integers(6, 20))) for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_recurrent_session_matches_reference(arch):
    """Five requests through ServeSessionProgram(slots=3) under "fused":
    slots are refilled, so a slot's recurrent state must be zeroed at
    admission, as the reference zeroes it. Tokens and counters equal."""
    jp, tp = session_params(arch, COMMON)
    jc, tc = JCluster(arch), TCluster(arch, device="cpu")
    with jc.policy("fused"):
        jprog = jc.compile(JSession(preempt=False, **COMMON))
    with tc.policy("fused"):
        tprog = tc.compile(TSession(**COMMON))
    reqs = _script()
    jtoks, jst = serve(jprog, jp, reqs)
    ttoks, tst = serve(tprog, tp, reqs)
    for (_, n), a, b in zip(reqs, jtoks, ttoks):
        assert b.size == n
        np.testing.assert_array_equal(b, a)
    for key in ("requests_done", "emitted_total", "occupancy_pct"):
        assert tst[key] == jst[key], key


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_recurrent_state_does_not_leak_across_requests(arch):
    """The last of five requests lands in a slot another request used
    (three slots): its tokens equal those it gets served alone."""
    _, tp = session_params(arch, COMMON)
    prog = TCluster(arch, device="cpu").compile(TSession(**COMMON))
    reqs = _script(seed=12)
    crowd, _ = serve(prog, tp, reqs)
    alone, _ = serve(prog, tp, reqs[-1:])
    np.testing.assert_array_equal(crowd[-1], alone[0])


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_recurrent_arch_refuses_the_paged_session(arch):
    """No positional K/V to page (recurrent state, a windowed local
    cache): the paged specs raise in both packages."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    with pytest.raises(ValueError):
        jsteps.paged_cache_specs(jcfg, 3, 40, n_pages=9, page_size=4)
    with pytest.raises(ValueError, match="pageable"):
        tsteps.paged_cache_specs(tcfg, 3, 40, n_pages=9, page_size=4)
    with pytest.raises(ValueError, match="pageable"):
        TCluster(arch, device="cpu").compile(
            TSession(paged=True, page_size=4, **COMMON))
    assert not any(tsteps.paged_cache_mask(tcfg, 3, 40).values())


def test_mlstm_refuses_a_ragged_chunking():
    """S = 12 against a chunk of 8: the reference's reshape cannot take
    it, and the port says why."""
    jcfg, tcfg, _, p = _block("xlstm-125m-smoke", "mlstm")
    with pytest.raises(ValueError, match="chunk"):
        tblocks.mlstm_block_apply(tcfg, p, torch.zeros(1, 12, 64), {})
