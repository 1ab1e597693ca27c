"""The SIFT frontend as the configuration defines it, written plainly:
Gaussian scale space, difference-of-Gaussian extrema, quadratic
refinement and the edge test, the strongest keypoints per octave,
upright 4×4×8 descriptors, and the lift of each keypoint through the
frame's xyz image.

The definition (Vedaldi-style pyramid, σ(o, s) = σ0·2^(o + s/3) with
σ0 = 1.6·2^(1/3), the input taken at blur 0.5):

* blur: separable Gaussian taps e^(−x²/2σ²), radius ⌈4σ⌉ (at least 1),
  normalised, zero outside the image; each level blurs the last by
  √(σ² − σ_last²);
* next octave: level s = 2 (σ = 3.2), every second row and column, at
  blur 1.6 in its own pixels;
* keypoints: 26-neighbour strict extrema beyond the peak threshold on
  DoG levels 1–3, at least 5 pixels from the border; offset −H⁻¹g of
  the 3×3×3 central differences (a determinant under 1e-12 in size is
  taken as 1e-12), every component under 1.5; |D + g·offset/2| beyond
  the threshold; tr²/det of the spatial Hessian under 11²/10; the
  ``keypoints_per_octave`` largest |D + g·offset/2| per octave, ties to
  the lower (level, row, column);
* gradients: central differences that wrap around the image edges;
* descriptor (upright): every pixel's magnitude split over 8
  orientation bins by a circular hat, the 8 planes of each level
  filtered by the separable hat max(0, 1 − |d|/Δ) with Δ = 3·σ of the
  level, sampled bilinearly (positions held in [0, size − 1.001]) at
  the keypoint's 4×4 bin centres spaced 3σ_keypoint, times
  e^(−(x² + y²)/8) in bin units; normalised, clipped at 0.2,
  renormalised;
* lift: the xyz pixel nearest the keypoint; kept where finite, at least
  0.4 m away, and of a confidence above half the frame's largest.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

S_LEVELS = 3
SIGMA0 = 1.6 * 2.0 ** (1.0 / S_LEVELS)
SIGMA_N = 0.5
BORDER = 5
EDGE_R = 10.0


class Features(NamedTuple):
    uv: torch.Tensor  # [F, K, 2] (column, row), input pixels
    desc: torch.Tensor  # [F, K, 128]
    xyz: torch.Tensor  # [F, K, 3] camera frame, 0 where not lifted
    valid: torch.Tensor  # [F, K]
    score: torch.Tensor  # [F, K] |refined DoG|


def gaussian_matrix(n: int, sigma: float, dtype, device) -> torch.Tensor:
    """[n, n] matrix whose product blurs along one axis (zero padding)."""
    radius = max(1, int(math.ceil(4.0 * sigma)))
    d = torch.arange(n, dtype=torch.float64)
    d = d[:, None] - d[None, :]
    taps = torch.exp(-0.5 * (torch.arange(-radius, radius + 1,
                                          dtype=torch.float64) / sigma) ** 2)
    g = torch.where(d.abs() <= radius,
                    torch.exp(-0.5 * (d / sigma) ** 2), torch.zeros(()))
    return (g / taps.sum()).to(dtype=dtype, device=device)


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    h, w = img.shape[-2:]
    gr = gaussian_matrix(h, sigma, img.dtype, img.device)
    gc = gaussian_matrix(w, sigma, img.dtype, img.device)
    return gr @ img @ gc.T


def octaves(img: torch.Tensor, n_octaves: int):
    """[(gaussian levels [F, 6, H, W], factor)] for each octave."""
    k = 2.0 ** (1.0 / S_LEVELS)
    out, cur, have = [], img, SIGMA_N
    for o in range(n_octaves):
        levels = []
        for s in range(-1, S_LEVELS + 2):
            want = SIGMA0 * k ** s
            if want > have:
                cur = blur(cur, math.sqrt(max(want ** 2 - have ** 2, 1e-12)))
                have = want
            levels.append(cur)
        out.append((torch.stack(levels, 1), 2 ** o))
        cur = levels[S_LEVELS][..., ::2, ::2]
        have = SIGMA0 * k ** (S_LEVELS - 1) / 2.0
    return out


def keypoints(dog: torch.Tensor, peak: float, n_keep: int):
    """The octave's keypoints of each frame: (row, col, level index,
    σ in octave pixels, score, valid), each [F, n_keep]."""
    n_f, n_l, h, w = dog.shape
    c = dog[:, 1:-1, 1:-1, 1:-1]
    nb_max = torch.full_like(c, -math.inf)
    nb_min = torch.full_like(c, math.inf)
    for dl in (0, 1, 2):
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                if (dl, dr, dc) == (1, 1, 1):
                    continue
                nb = dog[:, dl:n_l - 2 + dl, dr:h - 2 + dr, dc:w - 2 + dc]
                nb_max = torch.maximum(nb_max, nb)
                nb_min = torch.minimum(nb_min, nb)
    ext = ((c > nb_max) & (c > peak)) | ((c < nb_min) & (c < -peak))

    def at(dl, dr, dc):
        return dog[:, 1 + dl:n_l - 1 + dl, 1 + dr:h - 1 + dr,
                   1 + dc:w - 1 + dc]

    g = torch.stack([0.5 * (at(1, 0, 0) - at(-1, 0, 0)),
                     0.5 * (at(0, 1, 0) - at(0, -1, 0)),
                     0.5 * (at(0, 0, 1) - at(0, 0, -1))], -1)
    unit = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    hess = torch.empty(*c.shape, 3, 3, dtype=c.dtype, device=c.device)
    for i in range(3):
        for j in range(3):
            if i == j:
                e = unit[i]
                hess[..., i, i] = at(*e) + at(*(-x for x in e)) - 2 * c
            else:
                a = [x + y for x, y in zip(unit[i], unit[j])]
                b = [x - y for x, y in zip(unit[i], unit[j])]
                hess[..., i, j] = 0.25 * (at(*a) + at(*(-x for x in a))
                                          - at(*b) - at(*(-x for x in b)))
    det = torch.linalg.det(hess)
    held = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    solved = torch.linalg.solve_ex(hess, g)[0]
    off = -solved * (det / held)[..., None]  # (level, row, col)
    value = c + 0.5 * (g * off).sum(-1)
    hrr, hcc, hrc = hess[..., 1, 1], hess[..., 2, 2], hess[..., 1, 2]
    det2 = hrr * hcc - hrc * hrc
    edge = (det2 > 0) & ((hrr + hcc) ** 2 / torch.where(
        det2 == 0, torch.full_like(det2, 1e-12), det2)
        < (EDGE_R + 1) ** 2 / EDGE_R)
    lv = torch.arange(1, n_l - 1, device=c.device)[:, None, None]
    rw = torch.arange(1, h - 1, device=c.device)[None, :, None]
    cl = torch.arange(1, w - 1, device=c.device)[None, None, :]
    inside = ((lv >= 1) & (lv <= n_l - 2) & (rw >= BORDER) & (rw < h - BORDER)
              & (cl >= BORDER) & (cl < w - BORDER))
    ok = (ext & edge & inside & (off.abs() < 1.5).all(-1)
          & (value.abs() > peak))
    score = torch.zeros(n_f, n_l, h, w, dtype=c.dtype, device=c.device)
    score[:, 1:-1, 1:-1, 1:-1] = torch.where(ok, value.abs(), 0.0)
    offs = torch.zeros(n_f, n_l, h, w, 3, dtype=c.dtype, device=c.device)
    offs[:, 1:-1, 1:-1, 1:-1] = torch.where(ok[..., None], off, 0.0)
    order = torch.sort(score.reshape(n_f, -1), dim=-1, descending=True,
                       stable=True).indices[:, :n_keep]
    sc = torch.gather(score.reshape(n_f, -1), 1, order)
    o3 = torch.gather(offs.reshape(n_f, -1, 3), 1,
                      order[..., None].expand(-1, -1, 3))
    lvl, rem = order // (h * w), order % (h * w)
    row = (rem // w).to(c.dtype) + o3[..., 1]
    col = (rem % w).to(c.dtype) + o3[..., 2]
    sigma = SIGMA0 * 2.0 ** ((lvl.to(c.dtype) + o3[..., 0] - 1.0) / S_LEVELS)
    return row, col, lvl, sigma, sc, sc > 0


def gradients(gss: torch.Tensor):
    """Magnitude and angle of the wrapping central differences."""
    dx = 0.5 * (torch.cat([gss[..., 1:], gss[..., :1]], -1)
                - torch.cat([gss[..., -1:], gss[..., :-1]], -1))
    dy = 0.5 * (torch.cat([gss[..., 1:, :], gss[..., :1, :]], -2)
                - torch.cat([gss[..., -1:, :], gss[..., :-1, :]], -2))
    return torch.sqrt(dx * dx + dy * dy), torch.atan2(dy, dx)


def hat_filter(x: torch.Tensor, delta: float) -> torch.Tensor:
    """Separable hat max(0, 1 − |d|/Δ) over the last two axes of [N, H, W],
    zero outside."""
    r = int(math.floor(delta))
    taps = torch.clamp(1 - torch.arange(-r, r + 1, dtype=x.dtype,
                                        device=x.device).abs() / delta, min=0)
    y = F.conv2d(x[:, None], taps.reshape(1, 1, -1, 1), padding=(r, 0))
    return F.conv2d(y, taps.reshape(1, 1, 1, -1), padding=(0, r))[:, 0]


def descriptors(gss, lvl, row, col, sigma, valid):
    """Upright 128-D descriptors of the octave's keypoints [F, K, 128]."""
    n_f, n_l, h, w = gss.shape
    mag, ang = gradients(gss)
    a8 = torch.remainder(ang, 2 * math.pi) / (2 * math.pi) * 8
    bins = torch.arange(8, dtype=gss.dtype, device=gss.device)
    dist = (a8[..., None] - bins).abs()
    split = torch.clamp(1 - torch.minimum(dist, 8 - dist), min=0)
    planes = (mag[..., None] * split).permute(0, 1, 4, 2, 3)  # [F, L, 8, H, W]
    k = 2.0 ** (1.0 / S_LEVELS)
    filt = torch.stack([
        hat_filter(planes[:, lv].reshape(-1, h, w),
                   3.0 * SIGMA0 * k ** (lv - 1.0)).reshape(n_f, 8, h, w)
        for lv in range(n_l)], 1)  # [F, L, 8, H, W]
    centre = torch.arange(4, dtype=gss.dtype, device=gss.device) - 1.5
    step = 3.0 * sigma  # [F, K]
    u = torch.clamp(col[..., None, None] + centre[None, :] * step[..., None,
                                                                   None],
                    0, w - 1.001)  # [F, K, 1, 4] (bin column)
    v = torch.clamp(row[..., None, None] + centre[:, None] * step[..., None,
                                                                   None],
                    0, h - 1.001)  # [F, K, 4, 1] (bin row)
    u, v = torch.broadcast_tensors(u, v)  # [F, K, 4 rows, 4 cols]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    fi = torch.arange(n_f, device=gss.device)[:, None, None, None]
    li = lvl[..., None, None]
    img = filt.permute(0, 1, 3, 4, 2)  # [F, L, H, W, 8]

    def tap(dv, du):
        return img[fi, li, (v0.long() + dv), (u0.long() + du)]

    samp = ((tap(0, 0) * (1 - fu)[..., None] + tap(0, 1) * fu[..., None])
            * (1 - fv)[..., None]
            + (tap(1, 0) * (1 - fu)[..., None] + tap(1, 1) * fu[..., None])
            * fv[..., None])  # [F, K, 4, 4, 8]
    win = torch.exp(-(centre[:, None] ** 2 + centre[None, :] ** 2) / 8.0)
    d = (samp * win[..., None]).reshape(n_f, -1, 128)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(min=1e-8)
    d = torch.clamp(d, max=0.2)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(min=1e-8)
    return torch.where(valid[..., None], d, 0.0)


def lift(uv, valid, xyz, conf):
    """Each keypoint's xyz at its nearest pixel, and the lift's mask."""
    n_f, h, w = conf.shape
    col = torch.round(uv[..., 0]).long().clamp(0, w - 1)
    row = torch.round(uv[..., 1]).long().clamp(0, h - 1)
    fi = torch.arange(n_f, device=uv.device)[:, None]
    p = xyz[fi, row, col]
    finite = torch.isfinite(p).all(-1)
    p = torch.where(finite[..., None], p, 0.0)
    c = conf[fi, row, col]
    top = conf.reshape(n_f, -1).amax(-1)[:, None]
    ok = valid & finite & (torch.linalg.vector_norm(p, dim=-1) >= 0.4) & (
        c > 0.5 * top)
    return torch.where(valid[..., None], p, 0.0), ok


def sift_features(intensity, xyz, conf, n_octaves: int,
                  keypoints_per_octave: int, peak_thresh: float,
                  dtype=torch.float64) -> Features:
    """The frontend over [F, H, W] frames, in ``dtype``."""
    img = intensity.to(dtype)
    parts = []
    for gss, factor in octaves(img, n_octaves):
        dog = gss[:, 1:] - gss[:, :-1]
        row, col, lvl, sigma, score, valid = keypoints(
            dog, peak_thresh, keypoints_per_octave)
        desc = descriptors(gss, lvl, row, col, sigma, valid)
        uv = torch.stack([col * factor, row * factor], -1)
        parts.append((torch.where(valid[..., None], uv, 0.0), desc, score,
                      valid))
    uv, desc, score, valid = (torch.cat(x, 1) for x in zip(*parts))
    p, ok = lift(uv, valid, torch.nan_to_num(xyz.to(dtype)), conf.to(dtype))
    return Features(uv=uv, desc=desc, xyz=p, valid=ok, score=score)
