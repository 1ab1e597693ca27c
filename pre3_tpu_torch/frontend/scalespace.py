"""Gaussian scale space + DoG pyramid, batched over frames.

Port of ``pre3_tpu/frontend/scalespace.py``. The separable Gaussian blur
is a pair of ``F.conv2d`` with the reference's zero padding; octaves are
built by 2× subsampling. Every function takes any number of leading axes
before [H, W] (frames, pyramid levels).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pre3_tpu_torch.utils.device import cached_constant


def gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """1-D Gaussian taps (static, computed on the host)."""
    radius = max(1, int(math.ceil(truncate * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W], zero padding (the
    reference's SAME convolution)."""
    if sigma <= 0:
        return img
    k = cached_constant(
        ("gaussian_taps", sigma, img.dtype),
        lambda: torch.from_numpy(gaussian_kernel(sigma)).to(img.dtype),
        img.device)
    n = k.shape[0]
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = F.conv2d(x, k.reshape(1, 1, n, 1), padding=((n - 1) // 2, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, n), padding=(0, (n - 1) // 2))
    return x.reshape(*lead, h, w)


class Octave(NamedTuple):
    gss: torch.Tensor  # [..., S+3, H, W] Gaussian levels
    dog: torch.Tensor  # [..., S+2, H, W] difference-of-Gaussian levels
    sigmas: tuple  # static per-level absolute σ (octave units)
    downsample: int  # 2**o factor back to input resolution


def build_pyramid(
    img: torch.Tensor,  # [..., H, W]
    n_octaves: int = 3,
    s_levels: int = 3,
    sigma0: float = 1.6,
    sigma_n: float = 0.5,
) -> list[Octave]:
    """Vedaldi-style pyramid: levels s = -1..S+1 per octave with
    σ(o, s) = sigma0·2^(o + s/S); the input is taken to carry the nominal
    camera blur sigma_n. The level axis is the one before [H, W]."""
    k = 2.0 ** (1.0 / s_levels)
    octaves = []
    cur = img
    prev_sigma = sigma_n
    for o in range(n_octaves):
        levels = []
        sigmas = []
        run = cur
        run_sigma = prev_sigma
        for s in range(-1, s_levels + 2):
            target = sigma0 * (k**s)
            if target > run_sigma:
                inc = math.sqrt(max(target**2 - run_sigma**2, 1e-12))
                run = gaussian_blur(run, inc)
                run_sigma = target
            levels.append(run)
            sigmas.append(sigma0 * (k**s))
        gss = torch.stack(levels, dim=-3)
        dog = gss[..., 1:, :, :] - gss[..., :-1, :, :]
        octaves.append(
            Octave(gss=gss, dog=dog, sigmas=tuple(sigmas), downsample=2**o))
        # next octave: the level with σ = 2·sigma0 (position s_levels in
        # the -1-based list), subsampled 2×
        cur = levels[s_levels][..., ::2, ::2]
        prev_sigma = sigmas[s_levels] / 2.0  # σ in the subsampled grid
    return octaves


def gradient_polar(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient magnitude and angle of [..., H, W],
    wrapping around at the image edges as the reference's roll does."""
    dx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    dy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    return mag, ang
