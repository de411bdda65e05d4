"""Eval metrics: MSE, PSNR and SSIM (11x11 Gaussian window, Wang et al. 2004).

Counterpart of `tinynerf_tpu/train/metrics.py`.  SSIM's variance terms are
differences of O(1) quantities, so its convolutions run in float32 with
cuDNN's TF32 off (the JAX package uses Precision.HIGHEST for the same
reason); `eval_metrics` computes on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class TrainMetrics:
    loss: float = 0.0
    occupancy: float = 1.0


@dataclass
class EvalMetrics:
    mse_loss: float = 0.0
    psnr: float = 0.0
    ssim: float = 0.0


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.mean((x - y) ** 2))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """SSIM between two [h, w, c] float32 images in [0, max_val]."""
    c = x.shape[-1]
    k = torch.from_numpy(_gaussian_kernel()).to(x.device)
    weight = k[None, None].expand(c, 1, *k.shape).contiguous()  # depthwise

    def filt(img):  # [h, w, c] -> [h-10, w-10, c], 'VALID' padding
        out = F.conv2d(img.permute(2, 0, 1)[None], weight, groups=c)
        return out[0].permute(1, 2, 0)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        mu_x, mu_y = filt(x), filt(y)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sigma_x2 = filt(x * x) - mu_x2
        sigma_y2 = filt(y * y) - mu_y2
        sigma_xy = filt(x * y) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    return torch.mean(num / den)


def eval_metrics(pred: np.ndarray, target: np.ndarray) -> EvalMetrics:
    """Full-image eval on the host: [h, w, 3] images in [0, 1]."""
    p = torch.from_numpy(np.asarray(pred, np.float32))
    t = torch.from_numpy(np.asarray(target, np.float32))
    return EvalMetrics(
        mse_loss=float(torch.mean((p - t) ** 2)),
        psnr=float(psnr(p, t)),
        ssim=float(ssim(p, t)),
    )
