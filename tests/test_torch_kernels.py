"""repro_torch's fused kernels, rmsnorm and flash_attention against the
reference Pallas kernels, and the fused ops' compositions against the
reference's.

The same numpy inputs go through `repro.kernels.ops` under the "fused"
policy (the Pallas kernels, interpreted off-TPU) and through the port's
plain versions in `repro_torch.kernels` — the arithmetic the CUDA
kernels implement. Tolerances: f32 1e-5 (sum order only); bf16 2e-2
(sum order can flip one bf16 rounding of an intermediate). The rounding
traps are checked on their own: the port follows the Pallas *kernels*,
not the `ops._ref_*` oracles, where the two differ.

The CUDA kernels themselves run only on a GPU: `test_torch_cuda.py`
compares them with these plain versions there.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.policy import use_policy
from repro.kernels import ops as jops
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.kernels import fused, launches, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _mismatches(a, b) -> int:
    return int(np.sum(_np(a) != _np(b)))


# ----------------------------------------------------------------------------
# rmsnorm_matmul
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_rmsnorm_matmul_matches_pallas(dtype, m):
    rng = np.random.default_rng(m)
    k, n = 64, 48
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    sj, st = _pair(0.1 * rng.standard_normal(k).astype(np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((k, n), np.float32), dtype)
    with use_policy("fused"):
        want = jops.rmsnorm_matmul(xj, sj, wj)
    got = fused.rmsnorm_matmul(xt, st, wt)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    _close(got, want, dtype)


def test_rmsnorm_matmul_rounds_the_norm_before_the_product():
    """Trap (a): the Pallas prologue casts the normalised row to bf16
    before the product. The plain version does too; a version that keeps
    the norm in f32 disagrees with the kernel far more often."""
    rng = np.random.default_rng(7)
    m, k, n = 8, 64, 64
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), "bfloat16")
    sj, st = _pair(0.1 * rng.standard_normal(k).astype(np.float32),
                   "bfloat16")
    wj, wt = _pair(rng.standard_normal((k, n), np.float32), "bfloat16")
    with use_policy("fused"):
        want = jops.rmsnorm_matmul(xj, sj, wj)
    got = fused.rmsnorm_matmul_plain(xt, st, wt)
    xf = xt.float()
    xn = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6) \
        * (1 + st.float())
    unrounded = (xn @ wt.float()).to(torch.bfloat16)
    assert _mismatches(got, want) < _mismatches(unrounded, want)
    _close(got, want, "bfloat16")


# ----------------------------------------------------------------------------
# matmul_residual_add
# ----------------------------------------------------------------------------


# (k, n) by m: M <= 16 (the split-K path on the card) at K 80 N 40, and M >
# 16 with M, K and N that divide no tile of the card's mainloop
RESID_KN = {130: (200, 200)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8, 40, 130])
def test_matmul_residual_add_matches_pallas(dtype, m):
    rng = np.random.default_rng(10 + m)
    k, n = RESID_KN.get(m, (80, 40))
    aj, at = _pair(rng.standard_normal((m, k), np.float32), dtype)
    bj, bt = _pair(rng.standard_normal((k, n), np.float32), dtype)
    rj, rt = _pair(rng.standard_normal((m, n), np.float32), dtype)
    with use_policy("fused"):
        want = jops.matmul_residual_add(aj, bj, rj)
    got = fused.matmul_residual_add(at, bt, rt)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    _close(got, want, dtype)


def test_matmul_residual_add_rounds_twice_like_the_kernel():
    """Trap (b): the Pallas epilogue adds the residual to the *already
    rounded* bf16 product. With small integers every f32 sum is exact, so
    the plain version equals the Pallas kernel bit for bit, while the
    single-rounding oracle (`ops._ref_matmul_residual_add`, and the port's
    `ref.matmul_residual_add`) differs from it."""
    rng = np.random.default_rng(3)
    m, k, n = 8, 16, 64
    aj, at = _pair(rng.integers(-32, 33, (m, k)).astype(np.float32),
                   "bfloat16")
    bj, bt = _pair(rng.integers(-32, 33, (k, n)).astype(np.float32),
                   "bfloat16")
    res = rng.integers(-64, 65, (m, n)).astype(np.float32) + 0.375
    rj, rt = _pair(res, "bfloat16")
    with use_policy("fused"):
        kernel = jops.matmul_residual_add(aj, bj, rj)
    with use_policy("reference"):
        oracle = jops.matmul_residual_add(aj, bj, rj)
    got = fused.matmul_residual_add_plain(at, bt, rt)
    assert _mismatches(got, kernel) == 0
    assert _mismatches(kernel, oracle) > 0
    assert _mismatches(ref.matmul_residual_add(at, bt, rt), oracle) == 0


# ----------------------------------------------------------------------------
# flash_attention_proj
# ----------------------------------------------------------------------------


def _attn_inputs(seed, b, h, kv, s, hd, dm, dtype):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((b, h, s, hd), np.float32), dtype)
    k = _pair(rng.standard_normal((b, kv, s, hd), np.float32), dtype)
    v = _pair(rng.standard_normal((b, kv, s, hd), np.float32), dtype)
    wo = _pair(0.1 * rng.standard_normal((h, hd, dm)).astype(np.float32),
               dtype)
    return q, k, v, wo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,s", [(4, 2, 12), (10, 2, 24), (4, 4, 7)])
def test_flash_attention_proj_matches_pallas(dtype, h, kv, s):
    (qj, qt), (kj, kt), (vj, vt), (wj, wt) = _attn_inputs(
        h * s, 2, h, kv, s, 16, 32, dtype)
    with use_policy("fused"):
        want = jops.flash_attention_proj(qj, kj, vj, wj, causal=True)
    got = fused.flash_attention_proj(qt, kt, vt, wt, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (2, s, 32)
    _close(got, want, dtype)


def test_flash_attention_proj_rounds_p_and_head_outputs():
    """Trap (d): p is rounded to bf16 before p@v and each head's output to
    wo.dtype before the projection, with GQA h -> h // (H/KV). A version
    that keeps p and the head outputs in f32 disagrees with the kernel
    more often than the plain version does."""
    (qj, qt), (kj, kt), (vj, vt), (wj, wt) = _attn_inputs(
        5, 1, 10, 2, 24, 16, 64, "bfloat16")
    with use_policy("fused"):
        want = jops.flash_attention_proj(qj, kj, vj, wj, causal=True)
    got = fused.flash_attention_proj_plain(qt, kt, vt, wt, causal=True)
    kf = kt.repeat_interleave(5, dim=1).float()
    vf = vt.repeat_interleave(5, dim=1).float()
    sc = (qt.float() @ kf.transpose(-1, -2)) * 16 ** -0.5
    sc = sc.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), -1e30)
    o = torch.softmax(sc, -1) @ vf
    unrounded = torch.einsum("bhsk,hkd->bsd", o, wt.float()).to(
        torch.bfloat16)
    assert _mismatches(got, want) < _mismatches(unrounded, want)
    _close(got, want, "bfloat16")


def test_flash_attention_proj_full_attention_matches_pallas():
    (qj, qt), (kj, kt), (vj, vt), (wj, wt) = _attn_inputs(
        9, 1, 4, 2, 10, 16, 32, "float32")
    with use_policy("fused"):
        want = jops.flash_attention_proj(qj, kj, vj, wj, causal=False)
    _close(fused.flash_attention_proj(qt, kt, vt, wt, causal=False), want,
           "float32")


# ----------------------------------------------------------------------------
# dispatch and counting
# ----------------------------------------------------------------------------


def test_reference_mode_matches_the_reference_oracles():
    (qj, qt), (kj, kt), (vj, vt), (wj, wt) = _attn_inputs(
        11, 1, 4, 2, 12, 16, 32, "float32")
    with use_policy("reference"):
        want = jops.flash_attention_proj(qj, kj, vj, wj)
    from repro_torch.cluster.policy import use_policy as tuse
    with tuse("reference") as pol:
        got = ops.flash_attention_proj(qt, kt, vt, wt)
    assert pol.stats == {"ref_calls": 1}
    _close(got, want, "float32")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    launches.reset_counts()
    x = torch.randn(3, 16)
    out = fused.rmsnorm_matmul(x, torch.zeros(16), torch.randn(16, 8))
    assert out.shape == (3, 8)
    assert launches.counts()["rmsnorm_matmul"] == {"launches": 0,
                                                   "plain_cuda_calls": 0}


# ----------------------------------------------------------------------------
# rmsnorm
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(1, 64), (8, 96), (13, 40)])
def test_rmsnorm_matches_pallas(dtype, m, d):
    rng = np.random.default_rng(20 + m)
    xj, xt = _pair(rng.standard_normal((m, d), np.float32), dtype)
    sj, st = _pair(0.1 * rng.standard_normal(d).astype(np.float32), dtype)
    with use_policy("fused"):
        want = jops.rmsnorm(xj, sj)
    got = rmsnorm(xt, st)
    assert got.dtype == TDT[dtype] and got.shape == (m, d)
    _close(got, want, dtype)


# ----------------------------------------------------------------------------
# flash_attention
# ----------------------------------------------------------------------------


def _qkv(seed, b, h, kv, s, hd, dtype):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((b, h, s, hd), np.float32), dtype),
            _pair(rng.standard_normal((b, kv, s, hd), np.float32), dtype),
            _pair(rng.standard_normal((b, kv, s, hd), np.float32), dtype))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kv,s", [(4, 2, 12), (6, 2, 24), (4, 4, 7)],
                         ids=["gqa2", "gqa3", "mha"])
def test_flash_attention_matches_pallas_bf16(h, kv, s, causal):
    """S <= 512: the Pallas kernel's kv block spans the sequence, one
    softmax over all keys, as the plain version computes it."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(h * s, 2, h, kv, s, 16, "bfloat16")
    with use_policy("fused"):
        want = jops.flash_attention(qj, kj, vj, causal=causal)
    got = flash_attention(qt, kt, vt, causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, h, s, 16)
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_pallas_f32_past_one_block(causal):
    """S = 1024: the Pallas kernel walks two kv blocks of 512 with the
    online rescale; in f32 that equals one softmax to sum order."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(31, 1, 2, 1, 1024, 16, "float32")
    with use_policy("fused"):
        want = jops.flash_attention(qj, kj, vj, causal=causal)
    _close(flash_attention(qt, kt, vt, causal), want, "float32")


def test_flash_attention_rounds_p_before_pv():
    """p is rounded to v's dtype before p@v while l sums the unrounded p:
    a version that keeps p in f32 disagrees with the kernel more often."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(8, 1, 4, 2, 24, 16, "bfloat16")
    with use_policy("fused"):
        want = jops.flash_attention(qj, kj, vj, causal=True)
    got = flash_attention(qt, kt, vt, True)
    kf = kt.repeat_interleave(2, dim=1).float()
    vf = vt.repeat_interleave(2, dim=1).float()
    sc = (qt.float() @ kf.transpose(-1, -2)) * 16 ** -0.5
    sc = sc.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), -1e30)
    unrounded = (torch.softmax(sc, -1) @ vf).to(torch.bfloat16)
    assert _mismatches(got, want) < _mismatches(unrounded, want)


# ----------------------------------------------------------------------------
# matmul_bias_act
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", fused.ACTS)
@pytest.mark.parametrize("m", [3, 20])
def test_matmul_bias_act_matches_pallas(dtype, act, m):
    rng = np.random.default_rng(40 + m)
    k, n = 48, 40
    aj, at = _pair(rng.standard_normal((m, k), np.float32), dtype)
    bj, bt = _pair((k ** -0.5 * rng.standard_normal((k, n))).astype(
        np.float32), dtype)
    cj, ct = _pair(rng.standard_normal(n).astype(np.float32), dtype)
    with use_policy("fused"):
        want = jops.matmul_bias_act(aj, bj, cj, act=act)
    got = fused.matmul_bias_act(at, bt, ct, act)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    _close(got, want, dtype)


def test_matmul_bias_act_rounds_twice_like_the_kernel():
    """The Pallas epilogue adds the bias to the *already rounded* bf16
    product. With small integers every f32 sum is exact, so the plain
    version equals the Pallas kernel bit for bit, while the single-rounding
    oracle (`ops._ref_matmul_bias_act`, and the port's
    `ref.matmul_bias_act`) differs from it."""
    rng = np.random.default_rng(4)
    m, k, n = 8, 16, 64
    aj, at = _pair(rng.integers(-32, 33, (m, k)).astype(np.float32),
                   "bfloat16")
    bj, bt = _pair(rng.integers(-32, 33, (k, n)).astype(np.float32),
                   "bfloat16")
    bias = rng.integers(-64, 65, n).astype(np.float32) + 0.375
    cj, ct = _pair(bias, "bfloat16")
    with use_policy("fused"):
        kernel = jops.matmul_bias_act(aj, bj, cj, act="none")
    with use_policy("reference"):
        oracle = jops.matmul_bias_act(aj, bj, cj, act="none")
    got = fused.matmul_bias_act_plain(at, bt, ct, "none")
    assert _mismatches(got, kernel) == 0
    assert _mismatches(kernel, oracle) > 0
    assert _mismatches(ref.matmul_bias_act(at, bt, ct, "none"), oracle) == 0


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's F.gelu
    defaults to the exact erf form. The port's "gelu" is the tanh one."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = ref.ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


# ----------------------------------------------------------------------------
# the fused ops' compositions (their unfused lanes)
# ----------------------------------------------------------------------------

COMPOSITIONS = {
    "rmsnorm_matmul": dict(m=8, k=64, n=48),
    "matmul_bias_act": dict(m=12, k=48, n=40),
    "matmul_residual_add": dict(m=12, k=48, n=40),
    "flash_attention_proj": dict(b=2, h=4, kv=2, s=12, hd=16, dm=32),
}


def _comp_operands(name, dtype):
    """The same seeded numpy operands for both packages, in each op's
    operand order."""
    rng = np.random.default_rng(len(name))
    sh = COMPOSITIONS[name]
    if name == "flash_attention_proj":
        b, h, kv, s, hd, dm = (sh[k] for k in ("b", "h", "kv", "s", "hd",
                                               "dm"))
        shapes = [(b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd), (h, hd, dm)]
        scales = [1.0, 1.0, 1.0, 0.1]
    else:
        m, k, n = sh["m"], sh["k"], sh["n"]
        shapes = {"rmsnorm_matmul": [(m, k), (k,), (k, n)],
                  "matmul_bias_act": [(m, k), (k, n), (n,)],
                  "matmul_residual_add": [(m, k), (k, n), (m, n)]}[name]
        scales = [1.0, 0.1 if name == "rmsnorm_matmul" else k ** -0.5, 1.0]
    return [_pair((c * rng.standard_normal(shp)).astype(np.float32), dtype)
            for shp, c in zip(shapes, scales)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_composition_matches_reference(name, dtype):
    """`OPS[name].composition` against the reference's under "tuned":
    the primitive kernels (Pallas interpreted there, the plain versions
    here) with the epilogue in the framework's own ops."""
    pairs = _comp_operands(name, dtype)
    with use_policy("tuned"):
        want = jops.OPS[name].composition(*(j for j, _ in pairs))
    with tuse("tuned") as pol:
        got = ops.OPS[name].composition(*(t for _, t in pairs))
    assert pol.stats["kernel_calls"] >= 1 and "ref_calls" not in pol.stats
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    _close(got, want, dtype)
    assert ops.OPS[name].fused and ops.OPS[name].composition is not None


def test_new_ops_dispatch_and_check_blocks():
    x, s = torch.randn(8, 16), torch.zeros(16)
    with tuse("interpret") as pol:
        ops.rmsnorm(x, s, block_rows=4)
    assert pol.stats == {"plain_calls": 1}
    q = torch.randn(1, 2, 12, 16)
    with pytest.raises(ValueError, match="does not divide"):
        ops.flash_attention(q, q, q, bq=5)
    with tuse("reference") as pol:
        got = ops.flash_attention(q, q[:, :1], q[:, :1], causal=False)
    assert pol.stats == {"ref_calls": 1}
    _close(got, flash_attention(q, q[:, :1], q[:, :1], False), "float32")
