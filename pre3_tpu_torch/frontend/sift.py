"""SIFT detector + descriptor as dense tensor ops, batched over frames.

Port of ``pre3_tpu/frontend/sift.py``, both of its branches. The
reference picks one with ``PRE3_SIFT_FAST_MATH`` (``_fast_math``): the
exact branch (f32 throughout) and the fast-math branch, which rounds the
descriptor's band-filter operands and its interpolation taps to bf16 and
accumulates in f32. The port reads the same variable when ``extract_sift``
is called; unset, it runs the exact branch on every device (the
reference runs the fast one unset only on a TPU).

  detection    26-neighbour extrema as rolled-stack comparisons over the
               whole DoG stack (with the reference's wrap-around), closed-
               form 3×3 quadratic refinement + edge test, top-K per octave
               by |DoG| (stable, so the zero slots keep the reference's
               index order; both branches, see ``_detect_octave``)
  orientation  36-bin histograms by one-hot contraction over a fixed
               17×17 window, up to two peaks (upright=False only)
  descriptor   upright: dense orientation binning, a banded triangle
               filter per level (two matmuls; bf16 operands on the fast
               branch, tensor-core GEMMs on CUDA) and a 4-tap bilinear
               gather at each keypoint's 4×4 bin centres — the reference's
               one-hot contraction gives the same four products per
               output; rotated (upright=False): trilinear binning of a
               16×16 sample grid

Every function takes a leading frame axis (any leading axes where noted).
``extract_sift`` runs the frames in fixed chunks to bound the memory of
the dense stacks.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from pre3_tpu_torch.frontend.scalespace import (
    Octave, build_pyramid, gradient_polar,
)
from pre3_tpu_torch.utils.device import cached_constant
from pre3_tpu_torch.utils.topk import stable_topk

NBP = 4  # descriptor spatial bins
NBO = 8  # descriptor orientation bins
N_ORI_BINS = 36
MAGNIF = 3.0  # descriptor bin width in units of σ
DESC_SAMPLES = 16  # sample grid is DESC_SAMPLES × DESC_SAMPLES
ORI_RADIUS = 8  # orientation window half-size (octave pixels)
FRAME_CHUNK = 64  # frames per pass of extract_sift
TWO_PI = 2 * math.pi


class SiftFeatures(NamedTuple):
    uv: torch.Tensor  # [..., K, 2] input-resolution pixel positions
    scale: torch.Tensor  # [..., K] σ in input-resolution pixels
    orientation: torch.Tensor  # [..., K] radians
    desc: torch.Tensor  # [..., K, 128]
    score: torch.Tensor  # [..., K] |DoG| response
    valid: torch.Tensor  # [..., K] bool


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

_AXES = (-3, -2, -1)  # (level, row, col) of a [..., L, H, W] stack


def _local_extrema(dog: torch.Tensor, peak_thresh: float) -> torch.Tensor:
    """[..., S+2, H, W] → bool mask of 26-neighbourhood extrema (rolled,
    so the borders wrap; the caller masks them)."""
    neigh_max = torch.full_like(dog, -torch.inf)
    neigh_min = torch.full_like(dog, torch.inf)
    for dl in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dl == 0 and dr == 0 and dc == 0:
                    continue
                sh = torch.roll(dog, (-dl, -dr, -dc), dims=_AXES)
                neigh_max = torch.maximum(neigh_max, sh)
                neigh_min = torch.minimum(neigh_min, sh)
    is_max = (dog > neigh_max) & (dog > peak_thresh)
    is_min = (dog < neigh_min) & (dog < -peak_thresh)
    return is_max | is_min


def _refine(dog: torch.Tensor):
    """Quadratic subpixel refinement over the whole [..., L, H, W] stack.

    Returns (offset [..., L, H, W, 3] in (level, row, col) order, edge_ok,
    refined value). The 3×3 solve is the adjugate in closed form."""
    d = dog
    lv, rw, cl = _AXES

    def sh(shifts, dims):
        return torch.roll(d, shifts, dims)

    # first derivatives (central)
    gl = 0.5 * (sh(-1, lv) - sh(1, lv))
    gr = 0.5 * (sh(-1, rw) - sh(1, rw))
    gc = 0.5 * (sh(-1, cl) - sh(1, cl))
    # second derivatives
    hll = sh(-1, lv) + sh(1, lv) - 2 * d
    hrr = sh(-1, rw) + sh(1, rw) - 2 * d
    hcc = sh(-1, cl) + sh(1, cl) - 2 * d

    def cross(a, b):
        return 0.25 * (sh((-1, -1), (a, b)) + sh((1, 1), (a, b))
                       - sh((-1, 1), (a, b)) - sh((1, -1), (a, b)))

    hlr, hlc, hrc = cross(lv, rw), cross(lv, cl), cross(rw, cl)

    # Solve H x = -g via the adjugate of the symmetric 3×3 H.
    a, b_, c = hll, hlr, hlc
    e, f = hrr, hrc
    i = hcc
    det = a * (e * i - f * f) - b_ * (b_ * i - f * c) + c * (b_ * f - e * c)
    safe = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    a00 = e * i - f * f
    a01 = c * f - b_ * i
    a02 = b_ * f - c * e
    a11 = a * i - c * c
    a12 = b_ * c - a * f
    a22 = a * e - b_ * b_
    xl = -(a00 * gl + a01 * gr + a02 * gc) / safe
    xr = -(a01 * gl + a11 * gr + a12 * gc) / safe
    xc = -(a02 * gl + a12 * gr + a22 * gc) / safe
    offset = torch.stack([xl, xr, xc], dim=-1)
    refined = d + 0.5 * (gl * xl + gr * xr + gc * xc)
    # edge rejection on the spatial 2×2 Hessian (r = 10)
    r_edge = 10.0
    tr = hrr + hcc
    det2 = hrr * hcc - hrc * hrc
    edge_ok = (det2 > 0) & (
        tr * tr / torch.where(det2 == 0, 1e-12, det2)
        < (r_edge + 1) ** 2 / r_edge)
    return offset, edge_ok, refined


def _detect_octave(
    oct_: Octave, peak_thresh: float, max_keypoints: int, s_levels: int,
    sigma0: float,
):
    """Top-K keypoints of one octave per frame: (row, col, level, σ_oct,
    score, ok), each [..., K]."""
    dog = oct_.dog  # [..., L, H, W]
    n_lev, h, w = dog.shape[-3:]
    extrema = _local_extrema(dog, peak_thresh)
    offset, edge_ok, refined = _refine(dog)

    dev = dog.device
    levels = torch.arange(n_lev, device=dev)[:, None, None]
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    border = 5
    interior = ((levels >= 1) & (levels <= n_lev - 2)
                & (rows >= border) & (rows < h - border)
                & (cols >= border) & (cols < w - border))
    small_off = torch.all(torch.abs(offset) < 1.5, dim=-1)
    ok = extrema & edge_ok & interior & small_off & (
        torch.abs(refined) > peak_thresh)
    score = torch.where(ok, torch.abs(refined), 0.0)

    # Both branches: the reference's fast branch calls approx_max_k
    # (pre3_tpu/frontend/sift.py:159-166), whose lowering is approximate
    # only on a TPU; on the CPU and GPU it returns top_k's indices, ties
    # included, and that is what the port computes.
    vals, idx = stable_topk(score.flatten(-3), max_keypoints)
    lvl = idx // (h * w)
    rem = idx % (h * w)
    r = rem // w
    c = rem % w
    flat_off = offset.flatten(-4, -2)  # [..., L·H·W, 3]
    off = torch.gather(flat_off, -2, idx[..., None].expand(*idx.shape, 3))
    valid = vals > 0
    # refined continuous position/level
    r_f = r.to(torch.float32) + off[..., 1]
    c_f = c.to(torch.float32) + off[..., 2]
    s_f = lvl.to(torch.float32) + off[..., 0] - 1.0  # back to -1-based s
    k = 2.0 ** (1.0 / s_levels)
    sigma = sigma0 * torch.pow(k, s_f)
    return r_f, c_f, lvl, sigma, vals, valid


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------


def _corner_index(level, u0, v0, h: int, w: int):
    """Flat [L·H·W] index of (level, v0, u0) and its 3 bilinear partners."""
    base = level * (h * w) + v0 * w + u0
    return base, base + 1, base + w, base + w + 1


def _gather_bilinear_level(
    stack: torch.Tensor,  # [..., L, H, W]
    level: torch.Tensor,  # [..., K] int
    uv: torch.Tensor,  # [..., K, S, 2] float (u=col, v=row)
) -> torch.Tensor:
    """Bilinear sample per keypoint from its own pyramid level: [..., K, S]."""
    h, w = stack.shape[-2:]
    flat = stack.flatten(-3)  # [..., L·H·W]
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    corners = _corner_index(level[..., None], u0.long(), v0.long(), h, w)
    shape = u.shape
    at = [torch.gather(flat, -1, ix.flatten(-2)).reshape(shape)
          for ix in corners]
    return (at[0] * (1 - du) * (1 - dv) + at[1] * du * (1 - dv)
            + at[2] * (1 - du) * dv + at[3] * du * dv)


# ---------------------------------------------------------------------------
# Orientation
# ---------------------------------------------------------------------------


def _orientations(
    mag: torch.Tensor, ang: torch.Tensor, level: torch.Tensor,
    r_f: torch.Tensor, c_f: torch.Tensor, sigma: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 gradient orientations per keypoint: (θ₁, θ₂, has2), each
    [..., K]. Fixed (2R+1)² window, Gaussian weight σ_w = 1.5σ, 36-bin
    histogram by one-hot contraction, smoothed circularly twice, peaks
    refined by parabolic interpolation; the second peak is the best
    circular local maximum other than the first, kept at ≥ 80% of it."""
    dev = mag.device
    rr = torch.arange(-ORI_RADIUS, ORI_RADIUS + 1, dtype=torch.float32,
                      device=dev)
    gu, gv = torch.meshgrid(rr, rr, indexing="xy")
    grid = torch.stack([gu.ravel(), gv.ravel()], dim=-1)  # [S², 2]
    pts = torch.stack([c_f, r_f], dim=-1)[..., None, :] + grid
    m = _gather_bilinear_level(mag, level, pts)  # [..., K, S²]
    a = _gather_bilinear_level(ang, level, pts)
    d2 = torch.sum(grid * grid, dim=-1)  # [S²]
    sw = 1.5 * sigma[..., None]
    wgt = torch.exp(-d2 / (2.0 * sw * sw)) * m
    # one-hot histogram over 36 bins
    bin_f = (a % TWO_PI) / TWO_PI * N_ORI_BINS
    b0 = torch.floor(bin_f).long() % N_ORI_BINS
    frac = bin_f - torch.floor(bin_f)
    bins = torch.arange(N_ORI_BINS, device=dev)
    oh0 = (b0[..., None] == bins).to(torch.float32) * (1 - frac)[..., None]
    oh1 = ((b0[..., None] + 1) % N_ORI_BINS == bins).to(torch.float32) * (
        frac[..., None])
    hist = torch.einsum("...s,...sb->...b", wgt, oh0 + oh1)
    for _ in range(2):  # circular smoothing ×2
        hist = (hist + 0.5 * (torch.roll(hist, 1, -1)
                              + torch.roll(hist, -1, -1))) / 2.0

    def take(x, i):
        return torch.gather(x, -1, i[..., None])[..., 0]

    def refine(peak):
        hm = take(hist, peak)
        hl = take(hist, (peak - 1) % N_ORI_BINS)
        hr = take(hist, (peak + 1) % N_ORI_BINS)
        denom = hl - 2 * hm + hr
        dpk = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom,
                          0.0)
        return (peak + dpk) * (TWO_PI / N_ORI_BINS), hm

    peak1 = torch.argmax(hist, dim=-1)
    theta1, h1 = refine(peak1)
    is_max = (hist >= torch.roll(hist, 1, -1)) & (
        hist > torch.roll(hist, -1, -1))
    cand = torch.where(is_max & (bins != peak1[..., None]), hist, -torch.inf)
    peak2 = torch.argmax(cand, dim=-1)
    theta2, _ = refine(peak2)
    has2 = take(cand, peak2) >= 0.8 * h1
    return theta1, theta2, has2


# ---------------------------------------------------------------------------
# Descriptor
# ---------------------------------------------------------------------------


def _fast_math() -> bool:
    """The reference's branch switch (pre3_tpu/frontend/sift.py:292-305):
    ``PRE3_SIFT_FAST_MATH`` "1" runs the fast-math branch, "0" the exact
    one. Unset, the reference runs the fast branch only on a TPU; the
    port has none, so unset is exact on the CPU and on CUDA alike.
    ``extract_sift`` reads it once per call."""
    return os.environ.get("PRE3_SIFT_FAST_MATH") == "1"


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even) and held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] or [B, K, N] of bf16 operands, accumulated and
    returned in f32 (the reference's ``preferred_element_type``). On
    CUDA a bf16 tensor-core GEMM with an f32 output; elsewhere the f32
    product of the upcast operands (each bf16 × bf16 product is exact in
    f32, so only the summation order differs)."""
    if not b.is_cuda:
        return torch.matmul(a.float(), b.float())
    if b.dim() == 3:
        return torch.bmm(a.expand(b.shape[0], *a.shape), b,
                         out_dtype=torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)


def _band_matrix(n: int, delta: float) -> np.ndarray:
    """[n, n] banded triangle-filter matrix: B[p, q] = hat((p−q)/Δ)."""
    idx = np.arange(n)
    return np.maximum(
        0.0, 1.0 - np.abs(idx[:, None] - idx[None, :]) / delta
    ).astype(np.float32)


def _tri_sepconv(x: torch.Tensor, delta: float,
                 fast: bool = False) -> torch.Tensor:
    """Separable triangle (hat) filter of [..., H, W, C]:
    out(p) = Σ_q max(0, 1−|pᵣ−qᵣ|/Δ)·max(0, 1−|p_c−q_c|/Δ)·x(q),
    as two banded-matrix products. ``fast``: the reference's fast-math
    branch (pre3_tpu/frontend/sift.py:330-340): bf16 band matrices and
    input, f32 accumulation, the first product rounded to bf16."""
    h, w, c = x.shape[-3:]
    br, bc = (cached_constant(
        ("band_matrix", n, delta),
        lambda n=n: torch.from_numpy(_band_matrix(n, delta)), x.device)
        for n in (h, w))
    if not fast:
        y = torch.matmul(br, x.reshape(*x.shape[:-3], h, w * c))
        return torch.matmul(bc, y.reshape(x.shape))  # [..., H, W, C]
    br, bc, x = (a.to(torch.bfloat16) for a in (br, bc, x))
    y = _matmul_bf16(br, x.reshape(-1, h, w * c)).to(torch.bfloat16)
    # the column filter on the rows of yᵀ: one [N·H·C, W] × [W, W] GEMM
    yt = y.reshape(-1, w, c).mT.reshape(-1, w)
    out = _matmul_bf16(yt, bc.mT).reshape(-1, h, c, w).mT
    return out.reshape(x.shape)  # [..., H, W, C] f32


def _orientation_hat(ang: torch.Tensor) -> torch.Tensor:
    """Circular hat weights of angles to the NBO orientation bins:
    [...] → [..., NBO]."""
    af = (ang % TWO_PI) / TWO_PI * NBO
    ob = torch.arange(NBO, dtype=ang.dtype, device=ang.device)
    diff = torch.abs(af[..., None] - ob)
    circ = torch.minimum(diff, NBO - diff)
    return torch.clamp(1.0 - circ, min=0.0)


def _normalize_desc(desc: torch.Tensor) -> torch.Tensor:
    """Normalize → clamp at 0.2 → renormalize (Lowe)."""
    n1 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(n1, min=1e-8)
    desc = torch.clamp(desc, max=0.2)
    n2 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / torch.clamp(n2, min=1e-8)


def _descriptors_dense(
    mag: torch.Tensor, ang: torch.Tensor, level: torch.Tensor,
    r_f: torch.Tensor, c_f: torch.Tensor, sigma: torch.Tensor,
    s_levels: int, sigma0: float, fast: bool = False,
) -> torch.Tensor:
    """Upright 128-D descriptors by dense pre-binning: orientation hat
    binning of every pixel, a triangle filter per level at the level's
    nominal Δ_l = MAGNIF·σ_l, then per keypoint a bilinear sample at its
    4×4 bin centres (Gaussian window at the centres), normalize/clamp/
    renormalize. mag/ang [..., L, H, W] → [..., K, 128]. ``fast``: the
    reference's fast-math branch (bf16 band filters; bf16 binned stack
    and taps, pre3_tpu/frontend/sift.py:411-418)."""
    n_lev, h, w = mag.shape[-3:]
    k_scale = 2.0 ** (1.0 / s_levels)
    m8 = mag[..., None] * _orientation_hat(ang)  # [..., L, H, W, 8]
    binned = torch.stack([
        _tri_sepconv(m8[..., lv, :, :, :],
                     MAGNIF * sigma0 * k_scale ** (lv - 1.0), fast)
        for lv in range(n_lev)
    ], dim=-4)  # [..., L, H, W, 8]

    dev = mag.device
    centers = torch.arange(NBP, dtype=torch.float32, device=dev) - (
        NBP - 1) / 2.0
    gx, gy = torch.meshgrid(centers, centers, indexing="xy")
    gxy = torch.stack([gx.ravel(), gy.ravel()], dim=-1)  # [16, 2] bin units
    delta_k = (MAGNIF * sigma)[..., None]  # [..., K, 1] px per bin
    u = torch.clamp(c_f[..., None] + gxy[:, 0] * delta_k, 0.0, w - 1.001)
    v = torch.clamp(r_f[..., None] + gxy[:, 1] * delta_k, 0.0, h - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    taps = [1.0 - du, du, 1.0 - dv, dv]
    flat = binned.flatten(-4, -2)  # [..., L·H·W, 8]
    if fast:
        # the reference's contraction of bf16 one-hot taps with a bf16
        # source, f32 accumulation: each tap weight and the stack rounded
        # once; a bf16 × bf16 product is exact in f32
        taps = [_bf16(t) for t in taps]
        flat = flat.to(torch.bfloat16)
    corners = _corner_index(level[..., None], u0.long(), v0.long(), h, w)
    at = [torch.gather(flat, -2, ix.flatten(-2)[..., None].expand(
        *ix.shape[:-2], ix.shape[-2] * ix.shape[-1], NBO)).reshape(
            *ix.shape, NBO).float() for ix in corners]  # [..., K, 16, 8]
    # the reference's two one-hot contractions: column taps, then row taps
    u0w, u1w, v0w, v1w = taps
    row0 = at[0] * u0w + at[1] * u1w
    row1 = at[2] * u0w + at[3] * u1w
    samp = row0 * v0w + row1 * v1w  # [..., K, 16, 8]

    win = torch.exp(-torch.sum(gxy * gxy, dim=-1)
                    / (2.0 * (NBP / 2.0) ** 2))  # [16]
    desc = (samp * win[:, None]).flatten(-2)  # [..., K, 128]
    return _normalize_desc(desc)


def _descriptors(
    mag: torch.Tensor, ang: torch.Tensor, level: torch.Tensor,
    r_f: torch.Tensor, c_f: torch.Tensor, sigma: torch.Tensor,
    theta: torch.Tensor,
) -> torch.Tensor:
    """128-D descriptors: 4×4 spatial × 8 orientation trilinear binning
    over a rotated, σ-scaled 16×16 sample grid. → [..., K, 128]."""
    ns = DESC_SAMPLES
    dev = mag.device
    lin = (torch.arange(ns, dtype=torch.float32, device=dev) + 0.5) / ns * (
        NBP) - NBP / 2.0  # [-2, 2)
    gx, gy = torch.meshgrid(lin, lin, indexing="xy")
    gxy = torch.stack([gx.ravel(), gy.ravel()], dim=-1)  # [ns², 2] bin units

    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    # rotate then scale to pixels: offset = R(θ)·(x, y)·MAGNIF·σ
    scale = (MAGNIF * sigma)[..., None]
    ox = (ct * gxy[:, 0] - st * gxy[:, 1]) * scale
    oy = (st * gxy[:, 0] + ct * gxy[:, 1]) * scale
    pts = torch.stack([c_f[..., None] + ox, r_f[..., None] + oy], dim=-1)
    m = _gather_bilinear_level(mag, level, pts)  # [..., K, ns²]
    a = _gather_bilinear_level(ang, level, pts) - theta[..., None]

    # Gaussian window in bin units (σ_win = NBP/2)
    d2 = torch.sum(gxy * gxy, dim=-1)
    win = torch.exp(-d2 / (2.0 * (NBP / 2.0) ** 2))
    wm = m * win  # [..., K, ns²]
    # spatial hat weights to the 4 bins per axis (centres -1.5 .. 1.5)
    centers = torch.arange(NBP, dtype=torch.float32, device=dev) - (
        NBP - 1) / 2.0
    wx = torch.clamp(1.0 - torch.abs(gxy[:, 0:1] - centers), min=0.0)
    wy = torch.clamp(1.0 - torch.abs(gxy[:, 1:2] - centers), min=0.0)
    wyx = (wy[:, :, None] * wx[:, None, :]).flatten(-2)  # [ns², 16]
    wo = _orientation_hat(a)  # [..., K, ns², 8]
    # desc[k, (y, x), o] = Σ_s wm·wy·wx·wo
    desc = torch.einsum("...so,sb->...bo", wm[..., None] * wo, wyx)
    return _normalize_desc(desc.flatten(-2))


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def _extract_chunk(img, n_octaves, s_levels, keypoints_per_octave,
                   peak_thresh, upright, fast) -> SiftFeatures:
    sigma0 = 1.6 * 2.0 ** (1.0 / s_levels)
    octaves = build_pyramid(img, n_octaves=n_octaves, s_levels=s_levels,
                            sigma0=sigma0)
    outs = []
    for oct_ in octaves:
        r_f, c_f, lvl, sigma, score, valid = _detect_octave(
            oct_, peak_thresh, keypoints_per_octave, s_levels, sigma0)
        mag, ang = gradient_polar(oct_.gss)  # [F, L, H, W] each
        if upright:
            theta = torch.zeros_like(sigma)
            desc = _descriptors_dense(mag, ang, lvl, r_f, c_f, sigma,
                                      s_levels, sigma0, fast)
        else:
            # one keypoint per histogram peak (up to 2): the second peak
            # occupies a second [K] block, masked where it does not qualify
            theta1, theta2, has2 = _orientations(mag, ang, lvl, r_f, c_f,
                                                 sigma)
            theta = torch.cat([theta1, theta2], dim=-1)
            r_f, c_f, lvl, sigma = (torch.cat([x, x], dim=-1)
                                    for x in (r_f, c_f, lvl, sigma))
            score = torch.cat([score, torch.where(has2, score, 0.0)], dim=-1)
            valid = torch.cat([valid, valid & has2], dim=-1)
            desc = _descriptors(mag, ang, lvl, r_f, c_f, sigma, theta)
        ds = float(oct_.downsample)
        outs.append(SiftFeatures(
            uv=torch.stack([c_f * ds, r_f * ds], dim=-1), scale=sigma * ds,
            orientation=theta, desc=desc, score=score, valid=valid))
    return SiftFeatures(*(torch.cat(xs, dim=1) for xs in zip(*outs)))


def extract_sift(
    img: torch.Tensor,  # [F, H, W] float in [0, 1]
    n_octaves: int = 3,
    s_levels: int = 3,
    keypoints_per_octave: int = 128,
    peak_thresh: float = 0.004,
    upright: bool = True,
) -> SiftFeatures:
    """SIFT on F frames → fixed-capacity feature sets, every field with the
    leading frame axis: K = n_octaves·keypoints_per_octave per frame
    (doubled with upright=False: a second masked block for the second
    orientation peaks). upright=True assigns θ = 0, as the reference's
    default for RGB-D SLAM with small inter-frame roll. The branch follows
    ``PRE3_SIFT_FAST_MATH`` at this call (``_fast_math``)."""
    if img.dim() != 3:
        raise ValueError(f"extract_sift takes [F, H, W]; got {tuple(img.shape)}")
    fast = _fast_math()
    chunks = [_extract_chunk(part, n_octaves, s_levels, keypoints_per_octave,
                             peak_thresh, upright, fast)
              for part in torch.split(img, FRAME_CHUNK)]
    if len(chunks) == 1:
        return chunks[0]
    return SiftFeatures(*(torch.cat(xs, dim=0) for xs in zip(*chunks)))
