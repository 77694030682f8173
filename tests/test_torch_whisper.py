"""repro_torch's encoder-decoder model (whisper) against the reference, at
smoke size.

`whisper-small-smoke`: 2 encoder and 2 decoder layers, d_model 64, 4 heads
of 16, layer norm, the gelu MLP, 16 encoder frames. The reference's
parameters (`repro.models.steps.init_params`) are loaded into the port
with `weights.from_jax_params`; both models see the same tokens and the
same stub frame embeddings, made with numpy. Under "fused" the encoder's
MLP is the matmul_bias_act kernel (Pallas interpreted there, the plain
version here).

Tolerances: f32 logits within 1e-3 absolute + relative (sum order only,
through 4 layers and 5 layer norms of activations that reach |x| ~ 40);
one bf16 block within 2e-2 (sum order can flip one bf16 rounding). A
whole bf16 model is not compared: the reference runs its layers under a
jitted scan, whose fusions round elsewhere than the op-by-op blocks do,
and at |x| ~ 40 one bf16 ulp is 0.25, which the layer norms carry into
the logits. Greedy tokens are compared in f32, where no argmax is near a
tie.
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

POLICIES = ["tuned", "fused"]
MAX_SEQ = 32                  # decoder positions (whisper's is 448)
B, S = 2, 10


def _f32(t) -> np.ndarray:
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jreg.get("whisper-small-smoke"), treg.get(
        "whisper-small-smoke")
    jp = jsteps.init_params(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp, tp32 = (weights.from_jax_params(jax.tree.map(np.asarray, t),
                                        device="cpu") for t in (jp, jp32))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)).astype(
        np.float32)
    return jcfg, tcfg, (jp, tp), (jp32, tp32), tokens, frames


def _port_leaf(tp, keys):
    """The port's tensor for a reference leaf path: a stacked block tree's
    leading axis became a list index."""
    if keys[0] == "blocks":                     # blocks/sub0/...[i]
        return lambda i: _get(tp["blocks"][i], keys[2:])
    if keys[:2] == ["enc", "blocks"]:
        return lambda i: _get(tp["enc"]["blocks"][i], keys[2:])
    return _get(tp, keys)


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_param_specs_and_weights_round_trip(model):
    """Every leaf of the reference tree lands in the port's tree, leaf for
    leaf and bit for bit, and the port's own specs give the same shapes
    and dtypes."""
    jcfg, tcfg, (jp, tp), _, _, _ = model
    specs = tsteps.param_specs(tcfg, MAX_SEQ)
    n_port = sum(1 for _ in tsteps.iter_specs(specs))
    n_ref = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        got, spec = _port_leaf(tp, keys), _port_leaf(specs, keys)
        pairs = ([(got(i), spec(i), leaf[i]) for i in range(leaf.shape[0])]
                 if callable(got) else [(got, spec, leaf)])
        for t, sp, a in pairs:
            assert tuple(t.shape) == sp.shape == a.shape, keys
            assert t.dtype == sp.dtype == getattr(torch, a.dtype.name), keys
            np.testing.assert_array_equal(_f32(t), a.astype(np.float32))
            n_ref += 1
    assert n_ref == n_port
    assert len(tp["enc"]["blocks"]) == tcfg.n_enc_layers
    assert len(tp["blocks"]) == tcfg.n_layers
    assert tcfg.n_params() == jcfg.n_params()
    assert treg.get("whisper-small").n_params() == \
        jreg.get("whisper-small").n_params()


def test_weights_bridge_refuses_an_unknown_subtree(model):
    _, _, (jp, _), _, _, _ = model
    tree = jax.tree.map(np.asarray, jp)
    tree["adapter"] = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="adapter"):
        weights.from_jax_params(tree, device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_forward_logits_f32(model, policy):
    jcfg, tcfg, _, (jp, tp), tokens, frames = model
    with juse(policy):
        jh, _ = jsteps.forward(jcfg, jp, jnp.asarray(tokens),
                               cross_embeds=jnp.asarray(frames))
        want = jnp.einsum("bsd,dv->bsv", jh, jp["unembed"],
                          preferred_element_type=jnp.float32)
    with tuse(policy):
        th, _ = tsteps.forward(tcfg, tp, torch.from_numpy(tokens),
                               cross_embeds=torch.from_numpy(frames))
        got = tsteps.logits(tp, th)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("kind", ["enc_attn", "attn_cross"])
@pytest.mark.parametrize("policy", POLICIES)
def test_block_bf16(model, policy, kind):
    """One bf16 block, op by op on both sides: the encoder block (under
    "fused" its MLP is matmul_bias_act, rounding twice as the Pallas
    kernel does) and the decoder block against encoder frames."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks as tblocks
    jcfg, tcfg, (jp, tp), _, tokens, frames = model
    rng = np.random.default_rng(1)
    s = jcfg.enc_seq if kind == "enc_attn" else S
    x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
    enc = "enc_attn" == kind
    jlayer = jax.tree.map(lambda a: a[0], jp["enc"]["blocks"] if enc
                          else jp["blocks"]["sub0"])
    tlayer = tp["enc"]["blocks"][0] if enc else tp["blocks"][0]
    pos = np.broadcast_to(np.arange(s), (B, s))
    jctx = {"positions": jnp.asarray(pos), "rope": False,
            "cross_embeds": jnp.asarray(frames).astype(jnp.bfloat16)}
    tctx = {"positions": torch.from_numpy(pos.copy()), "rope": False,
            "cross_embeds": torch.from_numpy(frames).bfloat16()}
    with juse(policy):
        want, _ = jblocks.BLOCKS[kind]["apply"](
            jcfg, jlayer, jnp.asarray(x).astype(jnp.bfloat16), jctx)
    with tuse(policy) as pol:
        got, _ = tblocks.BLOCKS[kind]["apply"](
            tcfg, tlayer, torch.from_numpy(x).bfloat16(), tctx)
    fused_calls = 2 if enc and policy == "fused" else 0
    assert pol.stats.get("kernel_calls", 0) == fused_calls
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("policy", POLICIES)
def test_prefill_tokens_f32(model, policy):
    """make_prefill_step reads the frames from batch["enc_embeds"]."""
    jcfg, tcfg, _, (jp, tp), tokens, frames = model
    want = jsteps.make_prefill_step(jcfg, policy=policy)(
        jp, {"tokens": jnp.asarray(tokens), "enc_embeds": jnp.asarray(frames)})
    got = tsteps.make_prefill_step(tcfg, policy=policy)(
        tp, {"tokens": torch.from_numpy(tokens),
             "enc_embeds": torch.from_numpy(frames)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", POLICIES)
def test_decode_tokens_f32(model, policy):
    """Greedy decode on private caches: the prompt's first token, then 5
    steps fed back, dec_pos added at each position. Both caches start at
    zeros, cross K/V included (the reference fills no cross cache)."""
    jcfg, tcfg, _, (jp, tp), tokens, _ = model
    L, steps = 16, 6
    jc = jax.tree.map(lambda c: c.astype(jnp.float32),
                      jsteps.init_cache(jcfg, B, L))
    tc = {k: v.float() for k, v in
          tsteps.init_cache(tcfg, B, L, device="cpu").items()}
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: (tcfg.n_layers, *v.shape[1:])
        for k, v in jc["blocks"]["sub0"].items()}
    jstep = jax.jit(jsteps.make_decode_step(jcfg, max_seq=L, policy=policy))
    tstep = tsteps.make_decode_step(tcfg, max_seq=L, policy=policy)
    jtok, ttok = jnp.asarray(tokens[:, :1]), torch.from_numpy(tokens[:, :1])
    jout, tout = [], []
    for pos in range(steps):
        jc, jtok = jstep(jp, jc, {"tokens": jtok,
                                  "pos": jnp.asarray(pos, jnp.int32)})
        tc, ttok = tstep(tp, tc, {"tokens": ttok, "pos": pos})
        jout.append(np.asarray(jtok)[:, 0])
        tout.append(ttok.numpy()[:, 0])
    np.testing.assert_array_equal(np.stack(tout), np.stack(jout))
    np.testing.assert_allclose(
        _f32(tc["self_k"]), np.asarray(jc["blocks"]["sub0"]["self_k"]),
        rtol=1e-4, atol=1e-4)


def test_paged_decode_waits(model):
    """Whisper through the paged session: the paged cache pages the self
    K/V and keeps the cross K/V private, as the reference's does, and a
    decode step under a page table gives the private-cache step's tokens
    (f32). (Until the paged cache was ported both raised, hence the
    name.)"""
    jcfg, tcfg, _, (_, tp), tokens, _ = model
    specs = tsteps.paged_cache_specs(tcfg, B, 16, n_pages=9, page_size=4)
    jspecs = jsteps.paged_cache_specs(jcfg, B, 16, n_pages=9, page_size=4)
    assert {k: s.shape for k, s in specs.items()} == {
        k: (tcfg.n_layers, *s.shape[1:])
        for k, s in jspecs["blocks"]["sub0"].items()}
    assert tsteps.paged_cache_mask(tcfg, B, 16) == {
        "self_k": True, "self_v": True, "cross_k": False, "cross_v": False}
    step = tsteps.make_decode_step(tcfg, max_seq=16)
    private = {k: v.float() for k, v in
               tsteps.init_cache(tcfg, B, 16, device="cpu").items()}
    paged = {k: v.float() for k, v in tsteps.init_paged_cache(
        tcfg, B, 16, n_pages=9, page_size=4, device="cpu").items()}
    pages = (1 + torch.arange(B * 4)).reshape(B, 4)
    tok_a = tok_b = torch.from_numpy(tokens[:, :1])
    for pos in range(6):
        private, tok_a = step(tp, private, {"tokens": tok_a, "pos": pos})
        paged, tok_b = step(tp, paged, {"tokens": tok_b, "pos": pos,
                                        "pages": pages})
        assert torch.equal(tok_a, tok_b)
