"""Irregular workload (paper §8.2.2) and the hybrid addressing story, on
the PyTorch port (the flow of `examples/locality_pipeline.py`).

Runs histogram equalization — the paper's reduction-heavy irregular app —
in torch, smooths the result with the paper's 2dconv through the kernel
layer (`ops.tuned_call("conv2d", ...)` under a kernel-only `Cluster`: on
the card the hand-written CUDA kernel, raced or looked up by the tuning
layer), and shows the p_local effect: the same logical computation placed
with SEQUENTIAL vs INTERLEAVED region policies, with the traffic
difference predicted by MemPool's Top_H interconnect model (a model of
MemPool's L1, not of the card).

    PYTHONPATH=src python examples/locality_pipeline_torch.py

The image and the kernel live on the GPU; `--device cpu` runs the plain
versions on the CPU. `--size` sets the square image's side.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.cluster import Cluster  # noqa: E402
from repro_torch.core.interconnect import TOP_H, TopologyModel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

PHASES = (("lut_apply (sequential)", 0.95),
          ("histogram (interleaved)", 0.02))


def histogram_equalization(img: torch.Tensor, bins: int = 256
                           ) -> torch.Tensor:
    """Paper §8.2.2: contrast enhancement via the intensity CDF.

    Reductions (histogram) + serial step (CDF) + parallel map (LUT apply) —
    the structure that stresses synchronization on MemPool. `img` holds
    integer intensities in [0, bins); the result is uint8."""
    flat = img.reshape(-1).long()
    hist = torch.zeros(bins, dtype=torch.int64, device=img.device)
    hist.index_add_(0, flat, torch.ones_like(flat))            # reduction
    cdf = torch.cumsum(hist, 0)                                # serial scan
    cdf_min = cdf[torch.argmax((cdf > 0).to(torch.int32))]
    denom = torch.clamp(flat.numel() - cdf_min, min=1)
    lut = torch.round((cdf - cdf_min).float() / denom.float()
                      * (bins - 1)).to(torch.uint8)
    return lut[flat].reshape(img.shape)                        # parallel map


def low_contrast_image(size: int, device, seed: int = 0) -> torch.Tensor:
    """A synthetic low-contrast image: N(100, 20) intensities clipped to
    [0, 255], int32, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    img = torch.randn((size, size), generator=gen) * 20 + 100
    return torch.clamp(img, 0, 255).to(torch.int32).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)

    cluster = Cluster(device=args.device)        # kernel-only: no model
    img = low_contrast_image(args.size, cluster.device)
    eq = histogram_equalization(img)
    spread_before = int(img.max() - img.min())
    spread_after = int(eq.max() - eq.min())
    print(f"histogram equalization: intensity spread {spread_before} -> "
          f"{spread_after} (full range = 255)")
    assert spread_after > spread_before

    # the paper's 2dconv on the equalized image, dispatched through the
    # kernel-only Cluster's policy (its tuned plan, raced on a miss)
    w = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32,
                     device=cluster.device) / 16
    x = eq.to(torch.float32)
    with cluster.policy("tuned") as pol:
        smoothed = ops.tuned_call("conv2d", x, w)
    print(f"smoothed via conv2d on {cluster.device}: mean "
          f"{float(smoothed.mean()):.1f} (policy={pol.mode}, "
          f"stats={dict(pol.stats)})")

    # the p_local story on this workload: the LUT-apply phase is fully
    # local (SEQUENTIAL region); the histogram reduction is all-remote
    # (INTERLEAVED). MemPool's interconnect model quantifies the gap:
    m = TopologyModel(TOP_H)
    model = {}
    for phase, p_local in PHASES:
        lat = m.avg_latency(0.3, p_local=p_local)
        acc = m.accepted_load(1.0, p_local=p_local)
        model[phase] = (lat, acc)
        print(f"  {phase:28s} p_local={p_local:.2f} -> "
              f"latency={lat:.1f}cyc, accepted={acc:.2f} req/core/cyc")
    return {"image": img, "equalized": eq, "conv_input": x, "weights": w,
            "smoothed": smoothed, "model": model}


if __name__ == "__main__":
    main()
