"""Analytic FLOP accounting and the card's peak rates for MFU and
roofline numbers.

Every consumer divides by :func:`peak_flops` / :func:`hbm_bytes_per_sec`,
never by the raw constants, so the ``HVD_PEAK_FLOPS`` /
``HVD_PROFILE_HBM_GBPS`` overrides move every number at once.  The
defaults are NVIDIA's H100 SXM data-sheet figures (dense, no sparsity, at
the full 700 W power limit); a card set to a lower power limit runs below
them.
"""

from __future__ import annotations

from typing import Optional

from . import env as env_util

#: H100 SXM data sheet: dense bf16 tensor-core rate, FLOP/s
H100_PEAK_FLOPS = 989e12
#: H100 SXM data sheet: HBM3 bandwidth, bytes/s
H100_HBM_BYTES_PER_SEC = 3.35e12
#: H100 SXM data sheet: float32 rate outside the tensor cores, FLOP/s
H100_FP32_FLOPS = 67e12

#: ResNet-50 training ≈ 3 × 4.09 GFLOPs forward of model math per image
#: (the usual analytic count; the reference's headline MFU is built on it)
RESNET50_TRAIN_FLOPS_PER_IMG = 12.27e9


def peak_flops(default: float = H100_PEAK_FLOPS) -> float:
    """Per-card peak FLOP/s for MFU math; ``HVD_PEAK_FLOPS`` overrides."""
    return env_util.get_float(env_util.HVD_PEAK_FLOPS, default)


def hbm_bytes_per_sec(default: float = H100_HBM_BYTES_PER_SEC) -> float:
    """Per-card device-memory bandwidth for roofline math;
    ``HVD_PROFILE_HBM_GBPS`` overrides, in GB/s."""
    return env_util.get_float(env_util.HVD_PROFILE_HBM_GBPS,
                              default / 1e9) * 1e9


def image_model_mfu(img_per_sec_per_chip: float,
                    flops_per_image: float = RESNET50_TRAIN_FLOPS_PER_IMG,
                    *, peak: Optional[float] = None) -> float:
    """MFU of an image model from its measured per-card throughput."""
    peak = peak if peak is not None else peak_flops()
    return float(img_per_sec_per_chip) * float(flops_per_image) / peak
