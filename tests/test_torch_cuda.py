"""repro_torch's CUDA kernels against their plain versions, on the GPU.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode). It imports no jax, so it runs on a machine
with only PyTorch: `python -m pytest -q tests/test_torch_cuda.py`.
Tolerance: bf16 outputs within 2e-2 absolute + relative (one output
rounding, and f32 sums taken in another order).
"""

import pytest
import torch

from repro_torch.kernels import fused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 5120, 1024), (1, 5120, 17408),
                                   (3, 200, 72), (12, 300, 130),
                                   (70, 256, 130)])
def test_cuda_rmsnorm_matmul(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    s = (0.1 * torch.randn(k, generator=g, device=cuda)).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).bfloat16()
    before = fused.rmsnorm_matmul.launches
    got = fused.rmsnorm_matmul(x, s, w)
    torch.cuda.synchronize()
    assert fused.rmsnorm_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), fused.rmsnorm_matmul_plain(
        x, s, w).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 5120, 5120), (8, 17408, 5120),
                                   (5, 100, 36), (16, 72, 264),
                                   (40, 128, 96)])
def test_cuda_matmul_residual_add(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    b = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).bfloat16()
    r = torch.randn(m, n, generator=g, device=cuda).bfloat16()
    got = fused.matmul_residual_add(a, b, r)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fused.matmul_residual_add_plain(
        a, b, r).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,s,dm,causal", [(40, 8, 512, 256, True),
                                              (4, 2, 100, 256, True),
                                              (6, 3, 70, 256, False),
                                              (10, 2, 130, 144, True)])
def test_cuda_flash_attention_proj(cuda, h, kv, s, dm, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, h, s, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, kv, s, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, kv, s, 128, generator=g, device=cuda).bfloat16()
    wo = (torch.randn(h, 128, dm, generator=g, device=cuda)
          * (h * 128) ** -0.5).bfloat16()
    got = fused.flash_attention_proj(q, k, v, wo, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fused.flash_attention_proj_plain(
        q, k, v, wo, causal).float(), **BF16_TOL)


@pytest.mark.cuda
def test_cuda_graph_session_matches_eager(cuda):
    """The session step replayed as a CUDA graph gives the eager step's
    tokens, and a device trace of the graphed run sees as many kernel
    launches as the wrappers counted in the eager run."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster.session import Cluster, ServeSessionProgram
    from repro_torch.configs import get
    from repro_torch.models import steps
    from repro_torch.runtime import engine

    cfg = dataclasses.replace(get("qwen3-14b"), n_layers=2, d_model=256,
                              n_heads=4, n_kv_heads=2, d_ff=512, vocab=512)
    cluster = Cluster(cfg)
    spec = ServeSessionProgram(slots=4, max_seq=64, max_prompt=32, chunk=8,
                               paged=True, page_size=8)
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 512, 16)
    reqs = [(np.concatenate([pre, rng.integers(1, 512, i)]), 6 + i)
            for i in range(1, 7)]
    out, launches = [], []
    for graph in (True, False):
        with cluster.policy("fused"):
            prog = cluster.compile(spec)
        if not graph:
            prog._chunk_fn = engine.session_chunk_fn(
                steps.make_decode_step(cfg, max_seq=spec.max_seq,
                                       policy="fused"),
                spec.chunk, cuda_graph=False)
        sess = prog.open(params=prog.init_params(3))
        fused.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            handles = [sess.submit(p, n) for p, n in reqs]
            sess.drain()
            torch.cuda.synchronize()
        out.append([h.result() for h in handles])
        launches.append((fused.counts(), fused.traced_launches(prof)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    (g_counts, g_traced), (e_counts, e_traced) = launches
    eager = {k: c["launches"] for k, c in e_counts.items()}
    assert eager["rmsnorm_matmul"] > 0 and eager["matmul_residual_add"] > 0
    assert e_traced == eager == g_traced
    assert 0 < g_counts["rmsnorm_matmul"]["launches"] < eager[
        "rmsnorm_matmul"]
