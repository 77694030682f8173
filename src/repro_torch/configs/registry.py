"""Architecture configs for the PyTorch port.

A copy of `repro.configs.registry` without its JAX half (the reference
module imports jax at the top, so the port cannot import it): the same
`ArchConfig` fields, the same ten architectures with the same numbers, and
the same `smoke()` reduction, the workload shapes (`SHAPES`), and the kernel
tune records (`KernelTuneRecord`, `KERNEL_TUNES`) the tuning layer writes.
`input_specs` returns a shape and torch dtype record (`TensorSpec`) for
every model input of a workload, allocating nothing: the planner and the
program cells read them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm: str = "rms"            # rms | layer
    ffn_kind: str = "swiglu"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- attention window (SWA / local attention) ---
    window: int | None = None
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0
    # --- vlm ---
    cross_every: int = 0
    n_img_tokens: int = 0
    # --- hybrid/ssm block pattern, cycled over layers ---
    pattern: tuple[str, ...] = ("attn",)
    # --- recurrent dims ---
    lru_width: int = 0
    conv_width: int = 4
    # --- numerics / memory policy ---
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: str = "nothing"
    attn_chunk: int = 1024
    attn_schedule: str = "auto"   # auto | masked | folded | banded
    grad_accum: int = 1
    sub_quadratic: bool = False
    rules_overrides: tuple = ()
    moe_local_dispatch: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Total parameter count, from the port's own parameter specs."""
        from repro_torch.models import steps
        total = 0
        for spec in steps.iter_specs(steps.param_specs(self)):
            n = 1
            for d in spec.shape:
                n *= d
            total += n
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE discounts inactive experts)."""
        total = self.n_params()
        if self.n_experts and self.top_k:
            from repro_torch.models import steps
            expert = 0
            for spec in steps.iter_specs(steps.param_specs(self)["blocks"]):
                if "expert" in (spec.logical or ()):
                    n = 1
                    for d in spec.shape:
                        n *= d
                    expert += n
            total = total - expert + expert * self.top_k // self.n_experts
        return total


# ----------------------------------------------------------------------------
# Workload shapes (assignment)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


ARCHS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


QWEN15_32B = _reg(ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1e6,
    grad_accum=8))

YI_34B = _reg(ArchConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab=64000, rope_theta=5e6, grad_accum=8))

DEEPSEEK_67B = _reg(ArchConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab=102400, rope_theta=1e4, grad_accum=16))

QWEN3_14B = _reg(ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    grad_accum=4))

GROK_1 = _reg(ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    pattern=("attn_moe",), moment_dtype="bfloat16", grad_accum=16,
    remat="nothing"))

MIXTRAL_8X7B = _reg(ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000, n_experts=8, top_k=2,
    window=4096, pattern=("attn_moe",), rope_theta=1e6, grad_accum=4,
    sub_quadratic=True))

WHISPER_SMALL = _reg(ArchConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, norm="layer",
    ffn_kind="gelu", n_enc_layers=12, enc_seq=1500, pattern=("attn_cross",)))

XLSTM_125M = _reg(ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, head_dim=192,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"), sub_quadratic=True,
    rules_overrides=(("ffn", None), ("heads", None), ("kv_heads", None))))

RECURRENTGEMMA_9B = _reg(ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    ffn_kind="geglu", window=2048, lru_width=4096,
    pattern=("rglru", "rglru", "local_attn"), sub_quadratic=True,
    grad_accum=4))

LLAMA32_VISION_90B = _reg(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, rope_theta=5e5,
    cross_every=5, n_img_tokens=1601, pattern=("attn",), grad_accum=16))


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config: few layers, narrow, tiny vocab."""
    period = len(cfg.pattern)
    n_layers = max(2 * period, 2)
    if cfg.cross_every:
        n_layers = 2 * cfg.cross_every
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        window=min(cfg.window, 16) if cfg.window else None,
        lru_width=64 if cfg.lru_width else 0,
        attn_chunk=8,
        grad_accum=1,
        moment_dtype="float32",
    )


def get(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return smoke(ARCHS[name.removesuffix("-smoke")])
    return ARCHS[name]


# ----------------------------------------------------------------------------
# input_specs: abstract inputs per (arch x shape), no allocation
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, with nothing allocated (the port's
    `jax.ShapeDtypeStruct`)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """A `TensorSpec` for every model input of this workload."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": TensorSpec((B, S), i32),
                 "labels": TensorSpec((B, S), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": TensorSpec((B, S), i32)}
    elif shape.kind == "decode":
        batch = {"tokens": TensorSpec((B, 1), i32),
                 "pos": TensorSpec((), i32)}
    else:
        raise ValueError(shape.kind)
    if cfg.family == "encdec":
        batch["enc_embeds"] = TensorSpec((B, cfg.enc_seq, cfg.d_model),
                                         torch.bfloat16)
    if cfg.family == "vlm":
        batch["img_embeds"] = TensorSpec((B, cfg.n_img_tokens, cfg.d_model),
                                         torch.bfloat16)
    return batch


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (per assignment skip rules)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 524288 tokens; skipped per "
                       "assignment (noted in DESIGN.md §5)")
    return True, ""


# ----------------------------------------------------------------------------
# Kernel tune records (written by kernels/pipeline.autotune)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelTuneRecord:
    """One tuned plan for a (kernel, shape) cell — the reference's record.

    `blocks` / `default_blocks` are sorted (knob, value) tuples: on the
    card the Hopper kernels' own plan knobs (``tile_n``; ``boxes`` and
    ``cluster``), empty for a kernel whose tune space is one point.
    `modeled_seconds` are the cost-model scores the autotuner ranked the
    candidates with; `measured_us` / `default_us` the raced times of the
    winner and of the kernel's own plan, and `measured_speedup` their
    ratio. `source` is "timed" (raced), "modeled" (score-only) or "db"
    (warm-started from a TuneDB). `route` is "fused" (the kernel won) or
    "unfused" (the op's composition of primitive kernels won the race).
    """

    kernel: str
    shape_key: str
    blocks: tuple[tuple[str, int], ...]
    modeled_seconds: float
    default_blocks: tuple[tuple[str, int], ...] = ()
    default_modeled_seconds: float = 0.0
    saved_bytes: float = 0.0
    measured_us: float = 0.0
    default_us: float = 0.0
    source: str = "modeled"
    route: str = "fused"

    @property
    def timed(self) -> bool:
        return self.measured_us > 0.0

    @property
    def measured_speedup(self) -> float:
        """Raced speedup of the tuned plan over the default: >= 1.0 by
        construction for timed records, 1.0 for modeled ones."""
        if not self.timed:
            return 1.0
        return self.default_us / max(self.measured_us, 1e-30)


KERNEL_TUNES: dict[tuple[str, str], KernelTuneRecord] = {}


def register_kernel_tune(rec: KernelTuneRecord) -> KernelTuneRecord:
    KERNEL_TUNES[(rec.kernel, rec.shape_key)] = rec
    return rec


def get_kernel_tune(kernel: str, shape_key: str) -> KernelTuneRecord | None:
    return KERNEL_TUNES.get((kernel, shape_key))


def kernel_tunes() -> list[KernelTuneRecord]:
    return [KERNEL_TUNES[k] for k in sorted(KERNEL_TUNES)]
