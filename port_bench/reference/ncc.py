"""The warped-patch NCC map matcher as the configuration defines it
(3PRE's ``matching.m:27-180`` with ``pred_patch_fc.m``), written
plainly: each landmark's raw init patch, the patch it predicts in the
current view through its plane, and the correlation scan of its search
region.

The definition:

* at ``add``: the raw 21×21 intensity patch about the new landmark's
  pixel (bilinear, positions held in [0, size − 1.001]), kept with that
  pixel and the camera's pose (t, q);
* the predicted patch, each step: the landmark on a plane whose normal
  is the initial viewing ray (the landmark's world point less the
  initial camera centre, normalised); each pixel of the 11×11 patch
  about the landmark's predicted pixel h is undistorted into a ray of
  the current camera, the ray meets the plane at X = t + s·d (s held in
  [1e-3, 1e3], the ray's dot with the normal held at 1e-9 where it is
  smaller in size), X is seen from the initial pose and distorted into
  a pixel, and the init patch is read there bilinearly (held inside the
  patch); then less its mean and over its norm;
* the scan: 13×13 candidates h + (a·r_u, b·r_v) for a, b on the 13
  evenly spaced points of [−1, 1], with the half-axes r = 3·√diag(S)
  held in [2, 20] px; a candidate counts inside the ellipse
  dᵀ(S + 1e-9·I)⁻¹d ≤ χ²(2, 0.95) = 5.9915 and more than 11 px
  (the patch) inside each image border (u > 11, u < W − 12, and so for
  v); the image patch at each candidate (bilinear, less its mean, over
  its norm) correlates with the predicted patch as their inner
  product; the first best candidate (row of b, then a) is the match
  where its correlation is at least the threshold (0.60).

Departures: none in what is computed; every value is float64, and the
candidate grid's points are −1 + 2i/12 in float64.
"""

from __future__ import annotations

import torch

from port_bench.reference import geometry as geo
from port_bench.reference.fast import normalise, offsets, sample

INIT_PATCH = 21
PATCH = 11
GRID = 13
MIN_GATE, MAX_GATE = 2.0, 20.0
CHI2_95_2DOF = 5.9915
CAM, LM = 13, 6


def raw_patches(image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[A, 21, 21] raw init patches of image [H, W] about uv [A, 2]."""
    pts = uv[:, None, :] + offsets(INIT_PATCH, uv)[None]
    return sample(image, pts).reshape(-1, INIT_PATCH, INIT_PATCH)


def world_points(st) -> torch.Tensor:
    """[K, 3] world point of every slot (inverse-depth or Cartesian)."""
    k = st.active.shape[0]
    lms = st.x[CAM:].reshape(k, LM)
    return torch.where(st.is_id[:, None], geo.landmark_point(lms), lms[:, :3])


def predicted_patches(st, h: torch.Tensor) -> torch.Tensor:
    """[K, 121] each slot's init patch warped through its plane to the
    current pose, about its predicted pixel h [K, 2]."""
    t_c, q_c = st.x[0:3], st.x[3:7]
    t_i, q_i = st.init_cam[:, 0:3], st.init_cam[:, 3:7]
    lm = world_points(st)
    n = lm - t_i
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-9)
    pix = h[:, None, :] + offsets(PATCH, h)[None]  # [K, P², 2]
    ray_c = geo._centred(geo.undistort(pix))
    ray_c = torch.cat([ray_c, torch.ones_like(ray_c[..., :1])], -1)
    ray_w = geo.rotate(q_c, ray_c)
    dot = (ray_w * n[:, None]).sum(-1)
    dot = torch.where(dot.abs() < 1e-9, torch.full_like(dot, 1e-9), dot)
    s = (((lm - t_c) * n).sum(-1)[:, None] / dot).clamp(1e-3, 1e3)
    x_w = t_c + s[..., None] * ray_w
    uv_i = geo.pixel(geo.unrotate(q_i[:, None], x_w - t_i[:, None]))
    at = uv_i - st.init_uv[:, None] + (INIT_PATCH - 1) / 2
    return normalise(sample(st.init_patch, at))


def scan(st, h: torch.Tensor, s: torch.Tensor, visible: torch.Tensor,
         image: torch.Tensor, threshold: float):
    """(z [K, 2], matched [K]): the scan of every visible slot's search
    region of ``image`` [H, W] about h with the innovation covariance s
    [K, 2, 2]. A slot out of view is scanned about the image's centre
    with S = I, and never matched."""
    rows, cols = image.shape
    eye = torch.eye(2, dtype=h.dtype, device=h.device)
    h = torch.where(visible[:, None], h, torch.tensor(
        [cols / 2, rows / 2], dtype=h.dtype, device=h.device))
    s = torch.where(visible[:, None, None], s, eye)
    pred = predicted_patches(st, h)
    radius = (3 * torch.sqrt(torch.diagonal(s, dim1=-2, dim2=-1).clamp(
        min=1e-9))).clamp(MIN_GATE, MAX_GATE)  # [K, 2] (u, v)
    lin = -1 + 2 * torch.arange(GRID, dtype=h.dtype, device=h.device) / (
        GRID - 1)
    b, a = torch.meshgrid(lin, lin, indexing="ij")
    unit = torch.stack([a, b], -1).reshape(-1, 2)  # [G², 2]
    d = unit[None] * radius[:, None]  # [K, G², 2]
    centre = h[:, None] + d
    sol = torch.linalg.solve((s + 1e-9 * eye)[:, None],
                             d[..., None])[..., 0]
    inside = (d * sol).sum(-1) <= CHI2_95_2DOF
    u, v = centre[..., 0], centre[..., 1]
    inside &= ((u > PATCH) & (u < cols - PATCH - 1) & (v > PATCH)
               & (v < rows - PATCH - 1))
    pts = centre[:, :, None] + offsets(PATCH, h)[None, None]
    cand = normalise(sample(image, pts))  # [K, G², P²]
    ncc = (cand * pred[:, None]).sum(-1)
    ncc = torch.where(inside, ncc, -2.0)
    best = torch.argmax(ncc, dim=-1)
    z = centre[torch.arange(h.shape[0], device=h.device), best]
    matched = visible & (ncc.amax(-1) >= threshold)
    return torch.where(matched[:, None], z, 0.0), matched
