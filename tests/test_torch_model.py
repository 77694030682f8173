"""repro_torch's model against the reference model, at smoke size.

The reference parameters (`repro.models.steps.init_params`) are loaded
into the port with `weights.from_jax_params`; both models then see the
same tokens. Configs: `qwen3-14b-smoke` (4 heads, 4 kv heads) and a
2-kv-head variant that groups heads (GQA). Under "tuned" the plain route
runs, under "fused" the three fused kernels (Pallas interpreted on the
reference side, the plain versions on the port's CPU side).

Tolerances: logits and the K/V rows decode writes, in bf16, within 5e-2
absolute + relative (a 2-layer bf16 model: sum order flips single bf16
roundings of activations, which the next layer carries on). Greedy tokens must be equal; they
are compared with parameters and caches cast to f32 on both sides, where
the two models agree to ~1e-5 and no argmax is near a tie.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.cluster.policy import use_policy as juse
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.configs import registry as treg
from repro_torch.models import steps as tsteps

POLICIES = ["tuned", "fused"]
GQA = [4, 2]          # n_kv_heads (smoke n_heads is 4)


def _cfgs(n_kv):
    j = dataclasses.replace(jreg.get("qwen3-14b-smoke"), n_kv_heads=n_kv)
    t = dataclasses.replace(treg.get("qwen3-14b-smoke"), n_kv_heads=n_kv)
    return j, t


def _params(jcfg, dtype=None):
    jp = jsteps.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _f32(t) -> np.ndarray:
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module", params=GQA, ids=lambda n: f"kv{n}")
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    return jcfg, tcfg, _params(jcfg), _params(jcfg, jnp.float32)


def test_config_fields_equal_reference():
    for name in jreg.ARCHS:
        for n in (name, name + "-smoke"):
            j, t = jreg.get(n), treg.get(n)
            assert dataclasses.asdict(j) == dataclasses.asdict(t), n
    for n in ("qwen3-14b", "qwen3-14b-smoke"):
        assert treg.get(n).n_params() == jreg.get(n).n_params()


def test_param_specs_match_reference(model):
    jcfg, tcfg, (jp, tp), _ = model
    specs = tsteps.param_specs(tcfg)
    assert len(tp["blocks"]) == tcfg.n_layers == len(specs["blocks"])
    for key in ("tok_embed", "unembed", "ln_f"):
        assert tuple(tp[key].shape) == specs[key].shape == jp[key].shape
        assert tp[key].dtype == torch.bfloat16
    layer0 = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"])
    flat_j = jax.tree_util.tree_leaves_with_path(layer0)
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp["blocks"][0]
        for k in keys:
            t = t[k]
        np.testing.assert_array_equal(_f32(t), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("policy", POLICIES)
def test_forward_logits_bf16(model, policy):
    jcfg, tcfg, (jp, tp), _ = model
    tokens = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)
    with juse(policy):
        jh, _ = jsteps.forward(jcfg, jp, jnp.asarray(tokens))
        jl = jnp.einsum("bsd,dv->bsv", jh, jp["unembed"],
                        preferred_element_type=jnp.float32)
    with tuse(policy):
        th, _ = tsteps.forward(tcfg, tp, torch.from_numpy(tokens))
        tl = tsteps.logits(tp, th)
    assert th.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(_f32(tl), np.asarray(jl), rtol=5e-2,
                               atol=5e-2)


def test_chunked_schedule_matches_reference(model):
    """S = 24 > 2 * attn_chunk (8): both take the masked chunked schedule."""
    jcfg, tcfg, _, (jp, tp) = model
    tokens = np.random.default_rng(1).integers(0, 256, (1, 24)).astype(
        np.int32)
    with juse("tuned"):
        jh, _ = jsteps.forward(jcfg, jp, jnp.asarray(tokens))
    with tuse("tuned"):
        th, _ = tsteps.forward(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_f32(th), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("policy", POLICIES)
def test_prefill_tokens_f32(model, policy):
    jcfg, tcfg, _, (jp, tp) = model
    tokens = np.random.default_rng(2).integers(0, 256, (3, 10)).astype(
        np.int32)
    want = jsteps.make_prefill_step(jcfg, policy=policy)(
        jp, {"tokens": jnp.asarray(tokens)})
    got = tsteps.make_prefill_step(tcfg, policy=policy)(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decode_both(jcfg, tcfg, jp, tp, policy, cache_dtype, paged,
                 n_prompt=4):
    """Feed 3 slots a prompt token by token at per-slot positions, then
    decode greedily; returns both token streams and final caches."""
    B, L, steps = 3, 16, 9
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (B, n_prompt)).astype(np.int32)
    offs = np.array([0, 2, 5])                # per-slot start positions
    jc = jsteps.init_cache(jcfg, B, L)
    jc = jax.tree.map(lambda c: c.astype(cache_dtype), jc)
    tc = tsteps.init_cache(tcfg, B, L, device="cpu")
    tc = {k: v.to(getattr(torch, jnp.dtype(cache_dtype).name))
          for k, v in tc.items()}
    jbatch, tbatch = {}, {}
    if paged:
        ps, npp = 4, L // 4
        pages = (1 + np.arange(B * npp).reshape(B, npp)).astype(np.int32)
        n_pages = B * npp + 1
        jc = jsteps.init_paged_cache(jcfg, B, L, n_pages=n_pages,
                                     page_size=ps)
        jc = jax.tree.map(lambda c: c.astype(cache_dtype), jc)
        tc = tsteps.init_paged_cache(tcfg, B, L, n_pages=n_pages,
                                     page_size=ps, device="cpu")
        tc = {k: v.to(getattr(torch, jnp.dtype(cache_dtype).name))
              for k, v in tc.items()}
        jbatch["pages"] = jnp.asarray(pages)
        tbatch["pages"] = torch.from_numpy(pages).long()
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
        jc, jtok = jstep(jp, jc, dict(jbatch, tokens=jtok,
                                      pos=jnp.asarray(pos, jnp.int32)))
        tc, ttok = tstep(tp, tc, dict(tbatch, tokens=ttok,
                                      pos=torch.from_numpy(pos)))
        jout.append(np.asarray(jtok)[:, 0])
        tout.append(ttok.numpy()[:, 0])
    return np.stack(jout, 1), np.stack(tout, 1), jc, tc


@pytest.mark.parametrize("paged", [False, True], ids=["private", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_decode_tokens_f32(model, policy, paged):
    jcfg, tcfg, _, (jp, tp) = model
    jt, tt, _, _ = _decode_both(jcfg, tcfg, jp, tp, policy, jnp.float32,
                                paged)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("policy", POLICIES)
def test_decode_cache_bf16(model, policy):
    """The K/V rows decode writes, in bf16, agree with the reference's
    (every input token given, so the two runs see the same tokens)."""
    jcfg, tcfg, (jp, tp), _ = model
    _, _, jc, tc = _decode_both(jcfg, tcfg, jp, tp, policy, jnp.bfloat16,
                                False, n_prompt=9)
    for key in ("k", "v"):
        want = np.asarray(jc["blocks"]["sub0"][key], np.float32)
        np.testing.assert_allclose(_f32(tc[key]), want, rtol=5e-2,
                                   atol=5e-2)


# ----------------------------------------------------------------------------
# the "pallas" schedule and cross_attention
# ----------------------------------------------------------------------------


def _attn_operands(seed, b, s, h, kv, hd, dtype, s_kv=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, hd), (b, s_kv or s, kv, hd), (b, s_kv or s, kv, hd)]
    arrs = [rng.standard_normal(shp).astype(np.float32) for shp in shapes]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)],
                         ids=["causal", "full", "window"])
def test_pallas_schedule_matches_reference(dtype, causal, window):
    """schedule="pallas": causal attention without a window goes through
    the flash_attention kernel (Pallas interpreted there, the plain version
    here); the rest falls back to "auto" on both sides. Tolerance: f32
    1e-5, bf16 2e-2."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    (qj, kj, vj), (qt, kt, vt) = _attn_operands(5, 2, 20, 4, 2, 16, dtype)
    kw = dict(n_kv=2, causal=causal, window=window, chunk=8,
              schedule="pallas")
    with juse("tuned"):
        want = jattn.attention(qj, kj, vj, **kw)
    with tuse("tuned") as pol:
        got = tattn.attention(qt, kt, vt, **kw)
    assert pol.stats == ({"kernel_calls": 1} if causal and not window
                         else {})
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.shape == (2, 20, 4, 16) and got.dtype == qt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [12, 24], ids=["direct", "chunked"])
def test_cross_attention_matches_reference(s):
    """q of length s against a context of 10: s = 24 > 2 * chunk takes
    the q-chunked path on both sides (f32, 1e-5)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    (qj, kj, vj), (qt, kt, vt) = _attn_operands(6, 2, s, 4, 2, 16,
                                                "float32", s_kv=10)
    want = jattn.cross_attention(qj, kj, vj, n_kv=2, chunk=8)
    got = tattn.cross_attention(qt, kt, vt, n_kv=2, chunk=8)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_pallas_prefill_tokens_f32(model):
    """qwen3-14b-smoke with attn_schedule="pallas" under "tuned": the
    prefill's attention is the flash_attention kernel on both sides."""
    jcfg, tcfg, _, (jp, tp) = model
    jcfg = dataclasses.replace(jcfg, attn_schedule="pallas")
    tcfg = dataclasses.replace(tcfg, attn_schedule="pallas")
    tokens = np.random.default_rng(4).integers(0, 256, (3, 10)).astype(
        np.int32)
    want = jsteps.make_prefill_step(jcfg, policy="tuned")(
        jp, {"tokens": jnp.asarray(tokens)})
    with tuse("tuned") as pol:
        got = tsteps.make_prefill_step(tcfg)(
            tp, {"tokens": torch.from_numpy(tokens)})
    assert pol.stats == {"kernel_calls": tcfg.n_layers}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
