"""repro_torch's vision-language arch against the reference, at smoke size.

`llama-3.2-vision-90b-smoke`: 10 layers, two periods of four `attn`
blocks and one `cross` block (tanh-gated cross-attention to 8 image
embeddings, q/k norms), under "tuned" and "fused": the cross block alone,
the whole model's forward and prefill with `img_embeds`, decode, the
batch program, and the session on private caches and on the paged pool,
where only the `attn` blocks' K/V go into the pool and the `cross`
blocks' K/V stay private.

The reference draws the cross gates as zeros, which would leave the cross
blocks out of the model: both packages get them open (tanh(0.7) for the
attention, tanh(-0.4) for the FFN; `torch_parity.open_gates`), and the
attention weights at their true fan-in (`torch_parity.true_fan_in`).
Tolerances: f32 outputs and logits within 1e-4 absolute + relative; bf16
logits: 99.5% within 5e-2; tokens equal, with parameters and caches
cast to f32 on both sides. The decode cross-attends to the zero cache
(nothing in the reference fills it), as whisper's decoder does.
"""

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
from repro.models import steps as jsteps
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeProgram as TServe
from repro_torch.cluster.session import ServeSessionProgram as TSession
from repro_torch.configs import registry as treg
from repro_torch.models import blocks as tblocks
from repro_torch.models import steps as tsteps
from torch_parity import (decode_both, f32, params, port_layer, ref_layer,
                          serve, session_params)

ARCH = "llama-3.2-vision-90b-smoke"
POLICIES = ["tuned", "fused"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    return jcfg, tcfg, params(jcfg), params(jcfg, jnp.float32)


def _img(jcfg, B, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, jcfg.n_img_tokens, jcfg.d_model)).astype(np.float32)


def test_vlm_layout_and_gates(model):
    """Two periods of attn x 4 + cross; the cross block's f32 gates carry
    across open; its cache group holds the image tokens' K/V."""
    jcfg, tcfg, (jp, tp), _ = model
    assert tcfg.n_params() == jcfg.n_params()
    kinds = tsteps.layer_kinds(tcfg)
    assert kinds == (["attn"] * 4 + ["cross"]) * 2
    cross = tp["blocks"][4]
    assert cross["gate_attn"].dtype == torch.float32
    assert float(cross["gate_attn"]) == pytest.approx(0.7)
    assert float(cross["gate_ffn"]) == pytest.approx(-0.4)
    specs = tsteps.cache_specs(tcfg, 3, 40)
    assert {k: s.shape for k, s in specs.items()} == {
        "attn.k": (8, 3, 40, 4, 16), "attn.v": (8, 3, 40, 4, 16),
        "cross.k": (2, 3, 8, 4, 16), "cross.v": (2, 3, 8, 4, 16)}
    assert tsteps.layer_caches(tcfg)[9] == (
        {"k": "cross.k", "v": "cross.v"}, 1)


@pytest.mark.parametrize("policy", POLICIES)
def test_cross_block_matches_reference(model, policy):
    """The cross block alone (layer 4), f32: apply over 12 text rows and
    8 image rows, and one decode step against a seeded (non-zero) image
    cache, within 1e-4; the decode leaves its cache as it was."""
    jcfg, tcfg, _, (jp, tp) = model
    jl, tl = ref_layer(jcfg, jp, 4), tp["blocks"][4]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    img = _img(jcfg, 2)
    with juse(policy):
        want, _ = jblocks.cross_block_apply(jcfg, jl, jnp.asarray(x),
                                            {"cross_embeds": jnp.asarray(img)})
    with tuse(policy):
        got, _ = tblocks.cross_block_apply(tcfg, tl, torch.from_numpy(x),
                                           {"cross_embeds":
                                            torch.from_numpy(img)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kv = rng.standard_normal((2, 2, 8, 4, 16)).astype(np.float32)
    jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
    tc = {"k": torch.from_numpy(kv[0].copy()),
          "v": torch.from_numpy(kv[1].copy())}
    with juse(policy):
        want, _ = jblocks.cross_block_decode(jcfg, jl, jnp.asarray(x[:, :1]),
                                             jc, 3, {})
    with tuse(policy):
        got, ret = tblocks.cross_block_decode(tcfg, tl,
                                              torch.from_numpy(x[:, :1]),
                                              tc, 3, {})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ret["k"] is tc["k"] and np.array_equal(tc["k"].numpy(), kv[0])


@pytest.mark.parametrize("policy", POLICIES)
def test_vlm_forward_logits(model, policy):
    """Forward with img_embeds: f32 logits within 1e-4; bf16 99.5% within
    5e-2 of the reference (jitted)."""
    jcfg, tcfg, (jp, tp), (jp32, tp32) = model
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(
        np.int32)
    img = _img(jcfg, 2)
    for (j, t), dt in (((jp32, tp32), jnp.float32), ((jp, tp), jnp.bfloat16)):
        emb = jnp.asarray(img, dt)
        with juse(policy):
            jh, _ = jsteps.forward(jcfg, j, jnp.asarray(tokens),
                                   cross_embeds=emb)
            jl = np.asarray(jnp.einsum("bsd,dv->bsv", jh, j["unembed"],
                                       preferred_element_type=jnp.float32))
        with tuse(policy):
            th, _ = tsteps.forward(
                tcfg, t, torch.from_numpy(tokens),
                cross_embeds=torch.from_numpy(np.array(emb.astype(
                    jnp.float32))).to(t["tok_embed"].dtype))
            tl = f32(tsteps.logits(t, th))
        if dt == jnp.bfloat16:
            assert np.mean(np.abs(tl - jl) <= 5e-2 + 5e-2 * np.abs(jl)) \
                >= 0.995
        else:
            np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_vlm_prefill_tokens_f32(model, policy):
    """make_prefill_step with {"tokens", "img_embeds"}: S = 24 (three
    chunks of 8, the masked schedule), equal tokens."""
    jcfg, tcfg, _, (jp, tp) = model
    tokens = np.random.default_rng(2).integers(0, 256, (3, 24)).astype(
        np.int32)
    img = _img(jcfg, 3, seed=5)
    want = jsteps.make_prefill_step(jcfg, policy=policy)(
        jp, {"tokens": jnp.asarray(tokens), "img_embeds": jnp.asarray(img)})
    got = tsteps.make_prefill_step(tcfg, policy=policy)(
        tp, {"tokens": torch.from_numpy(tokens),
             "img_embeds": torch.from_numpy(img)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", POLICIES)
def test_vlm_decode_tokens_f32(model, policy):
    """3 slots at per-slot positions, 12 steps: tokens equal; the attn
    layers' K/V within 1e-4, the cross layers' caches still zero."""
    jcfg, tcfg, _, (jp, tp) = model
    jt, tt, jc, tc = decode_both(jcfg, tcfg, jp, tp, policy, L=20, steps=12)
    np.testing.assert_array_equal(tt, jt)
    for i in range(tcfg.n_layers):
        want, got = ref_layer(jcfg, jc, i), port_layer(tcfg, tc, i)
        for k in want:
            np.testing.assert_allclose(f32(got[k]), np.asarray(want[k]),
                                       **TOL, err_msg=f"layer {i} {k}")
    assert not tc["cross.k"].any() and not tc["cross.v"].any()


COMMON = dict(slots=3, max_seq=40, max_prompt=10, chunk=4)


@pytest.mark.parametrize("chunk", [1, 4])
def test_vlm_serve_program_matches_reference(chunk, monkeypatch):
    """ServeProgram(batch=3, max_seq=40, max_new=16) with a 6-token
    prompt: tokens and emitted counts equal the reference's."""
    jp, tp = session_params(ARCH, COMMON)
    jinit, tinit = jsteps.init_cache, tsteps.init_cache
    monkeypatch.setattr(jsteps, "init_cache", lambda *a, **k: jax.tree.map(
        lambda c: c.astype(jnp.float32), jinit(*a, **k)))
    monkeypatch.setattr(tsteps, "init_cache", lambda *a, **k: {
        n: c.float() for n, c in tinit(*a, **k).items()})
    spec = dict(batch=3, max_seq=40, max_new=16, chunk=chunk)
    prompt = np.random.default_rng(9).integers(1, 200, (3, 6))
    want = JCluster(ARCH).compile(JServe(**spec)).run(params=jp,
                                                      prompt=prompt)
    got = TCluster(ARCH, device="cpu").compile(TServe(**spec)).run(
        params=tp, prompt=prompt)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["stats"]["emitted_per_slot"] == \
        want["stats"]["emitted_per_slot"]


def test_vlm_paged_mask_pools_only_the_attn_kv():
    """Paged: the attn groups' K/V become pools (8 layers, n_pages,
    page_size, KV, hd); the cross K/V stay private (2, B, 8, KV, hd), as
    the reference's `paged_cache_mask` decides for sub0-3 and sub4."""
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    mask = tsteps.paged_cache_mask(tcfg, 3, 40)
    assert mask == {"attn.k": True, "attn.v": True, "cross.k": False,
                    "cross.v": False}
    jmask = jsteps.paged_cache_mask(jcfg, 3, 40)["blocks"]
    assert [jmask[f"sub{i}"]["k"] for i in range(5)] == [True] * 4 + [False]
    specs = tsteps.paged_cache_specs(tcfg, 3, 40, n_pages=31, page_size=4)
    assert specs["attn.k"].shape == (8, 31, 4, 4, 16)
    assert specs["cross.v"].shape == (2, 3, 8, 4, 16)


@pytest.mark.parametrize("paged", [False, True], ids=["private", "paged"])
def test_vlm_session_matches_reference(paged):
    """Five requests through ServeSessionProgram(slots=3) under "fused",
    on private caches and on the paged pool (page_size 4): tokens and
    counters equal, and the pool's counters too."""
    jp, tp = session_params(ARCH, COMMON)
    extra = dict(paged=True, page_size=4) if paged else {}
    jc, tc = JCluster(ARCH), TCluster(ARCH, device="cpu")
    with jc.policy("fused"):
        jprog = jc.compile(JSession(preempt=False, **COMMON, **extra))
    with tc.policy("fused"):
        tprog = tc.compile(TSession(**COMMON, **extra))
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(1, 200, int(rng.integers(2, 10))).astype(np.int32),
             int(rng.integers(6, 20))) for _ in range(5)]
    jtoks, jst = serve(jprog, jp, reqs)
    ttoks, tst = serve(tprog, tp, reqs)
    for (_, n), a, b in zip(reqs, jtoks, ttoks):
        assert b.size == n
        np.testing.assert_array_equal(b, a)
    for key in ("requests_done", "emitted_total", "occupancy_pct"):
        assert tst[key] == jst[key], key
    if paged:
        assert tst["kv"] == {k: jst["kv"][k] for k in tst["kv"]}
