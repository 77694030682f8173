"""repro_torch's other dense archs against the reference, at smoke size.

`qwen1.5-32b-smoke` (qkv bias, as many kv heads as heads), `yi-34b-smoke`
and `deepseek-67b-smoke` (plain GQA; at smoke size 4 kv heads for 4
heads), each under "tuned" and "fused": forward logits, prefill tokens and
decode tokens (per-slot positions through private caches), as
`tests/test_torch_model.py` runs qwen3-14b-smoke. The reference draws the
qkv biases as zeros, so they are drawn again here, from a seeded numpy
generator, and given to both packages: a zero bias would hold nothing.

Tolerances: logits in f32 within 1e-4 absolute + relative; tokens
equal; parameters and caches cast to f32 on both sides, where no greedy
argmax sits near a tie. The bf16 route is the one `test_torch_model.py`
holds at 5e-2 on qwen3: here the random biases sharpen the softmax so
that bf16 roundings part the two packages' logits by up to 0.4 (where
f32 agrees within 5e-6).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.policy import use_policy as juse
from repro.configs import registry as jreg
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.configs import registry as treg
from repro_torch.models import steps as tsteps

ARCHS = ["qwen1.5-32b-smoke", "yi-34b-smoke", "deepseek-67b-smoke"]


def _with_biases(jp):
    """Seeded non-zero qkv biases (N(0, 0.25)) where the arch has them."""
    rng = np.random.default_rng(11)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (jnp.asarray(0.5 * rng.standard_normal(v.shape),
                                 v.dtype) if k in ("bq", "bk", "bv") else v))
                for k, v in tree.items()}

    return walk(jp)


def _params(jcfg, dtype=None):
    jp = _with_biases(jsteps.init_params(jcfg, jax.random.PRNGKey(0)))
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, weights.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _f32(t) -> np.ndarray:
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _decode(jcfg, tcfg, jp, tp, policy):
    B, L, steps = 3, 16, 9
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (B, 4)).astype(np.int32)
    offs = np.array([0, 2, 5])
    jc = jax.tree.map(lambda c: c.astype(jnp.float32),
                      jsteps.init_cache(jcfg, B, L))
    tc = {k: v.float() for k, v in
          tsteps.init_cache(tcfg, B, L, device="cpu").items()}
    jstep = jax.jit(jsteps.make_decode_step(jcfg, max_seq=L, policy=policy))
    tstep = tsteps.make_decode_step(tcfg, max_seq=L, policy=policy)
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
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
    return np.stack(jout, 1), np.stack(tout, 1)


@pytest.mark.parametrize("policy", ["tuned", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_arch_matches_reference(arch, policy):
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    assert tcfg.n_params() == jcfg.n_params()
    jp32, tp32 = _params(jcfg, jnp.float32)
    if tcfg.qkv_bias:
        assert float(tp32["blocks"][0]["attn"]["bk"].abs().max()) > 0

    tokens = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)
    with juse(policy):
        jh, _ = jsteps.forward(jcfg, jp32, jnp.asarray(tokens))
        jl = jnp.einsum("bsd,dv->bsv", jh, jp32["unembed"],
                        preferred_element_type=jnp.float32)
    with tuse(policy):
        th, _ = tsteps.forward(tcfg, tp32, torch.from_numpy(tokens))
        tl = tsteps.logits(tp32, th)
    np.testing.assert_allclose(_f32(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)

    # S = 24 > 2 * attn_chunk: the masked chunked schedule on both sides
    tokens = np.random.default_rng(2).integers(0, 256, (3, 24)).astype(
        np.int32)
    want = jsteps.make_prefill_step(jcfg, policy=policy)(
        jp32, {"tokens": jnp.asarray(tokens)})
    got = tsteps.make_prefill_step(tcfg, policy=policy)(
        tp32, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jt, tt = _decode(jcfg, tcfg, jp32, tp32, policy)
    np.testing.assert_array_equal(tt, jt)
