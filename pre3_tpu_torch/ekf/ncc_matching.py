"""Warped-patch NCC map matching — the FAST/NCC measurement path.

Port of ``pre3_tpu/ekf/ncc_matching.py``. For every map feature, scan a
fixed G×G grid of candidate pixels scaled to the feature's own 3σ search
box of S, correlate the image patch at each candidate against the
feature's warped init patch (``frontend/patch_warp.py``), and accept the
best candidate with NCC ≥ 0.60. Zero-mean unit-norm patches make NCC an
inner product. The stored appearance is never refreshed: the init patch
is warped every frame.

The reference samples the K·G²·P² candidate pixels with two separable
one-hot-blend matmuls, a TPU form. Here the same separable bilinear
interpolation is two gathers: the two image rows of every candidate row
coordinate are blended into [K, G·P, W], then the two columns of every
candidate column coordinate into [K, G·P, G·P]. All in f32 (the port
keeps TF32 off). ``torch.linalg.inv_ex`` inverts S without the error
check that would wait for the card.

A slot the scan does not measure (out of view or inactive, or with a
non-finite pixel or S) is held at the image's centre with the smallest
gate before anything is read: an inactive slot is a Cartesian point at
the world origin, whose pixel overflows and whose S reads NaN when the
camera's plane passes near the origin, and a NaN coordinate would floor
to an index outside the image. Such a slot is never matched, and no
measured slot's value depends on it.

While the tracer is on, two more probes of the stage ``slam_step.match``
split it: one before the warp of the init patches (``predict_patches``),
one before the candidate scan (gathers, NCC, the best candidate and its
xyz sample).
"""

from __future__ import annotations

import numpy as np
import torch

from pre3_tpu_torch.ekf.measurement import Observations
from pre3_tpu_torch.ekf.state import EkfState
from pre3_tpu_torch.frontend.patch_warp import predict_patches
from pre3_tpu_torch.frontend.patches import bilinear_sample
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.inverse_depth import inverse_depth_to_cartesian
from pre3_tpu_torch.utils import profiling
from pre3_tpu_torch.utils.device import cached_constant

CHI2_2DOF_95 = 5.9915  # χ²(2, 0.95) — the reference's ellipse gate


def grid_unit(grid: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[G] candidate offsets in [-1, 1], bit-equal to the reference's
    ``jnp.linspace(-1, 1, G)`` under ``jit`` (how its ``run_slam`` runs
    it): XLA multiplies by the f32 reciprocal of G-1 and blends the two
    ends, s = i·f32(1/(G-1)), -1·(1-s) + s, each op rounded to f32. Built
    in numpy f32 on the host once per (grid, dtype, device) and kept
    there."""
    def build():
        one = np.float32(1.0)
        s = np.arange(grid, dtype=np.float32) * (one / np.float32(grid - 1))
        lin = np.float32(-1.0) * (one - s) + s
        return torch.from_numpy(lin).to(dtype)

    return cached_constant(("ncc_grid", grid, dtype), build, device or "cpu")


def search_ic_matches_ncc(
    cam: Camera,
    obs: Observations,
    state: EkfState,
    image: torch.Tensor,  # [H, W] current intensity image
    xyz_img: torch.Tensor | None = None,  # [H, W, 3] camera-frame points
    patch: int = 11,
    grid: int = 13,
    ncc_threshold: float = 0.60,
    max_gate_px: float = 20.0,
    min_gate_px: float = 2.0,
) -> Observations:
    """Match every visible map feature by warped-patch NCC. Returns obs
    with z / ic / z_xyz filled; candidates are limited to the
    Mahalanobis ellipse of S and the image bounds."""
    k = state.n_landmarks
    dt, dev = image.dtype, image.device
    h_img, w_img = image.shape
    lms = state.landmarks
    lms_w = torch.where(state.is_id[:, None],
                        inverse_depth_to_cartesian(lms), lms[:, :3])
    # unmeasured slots at the image's centre with S = (min gate / 3)²·I
    # (see the module docstring): every coordinate below is finite
    eye2 = torch.eye(2, dtype=dt, device=dev)
    live = (obs.visible & state.active & torch.isfinite(obs.h).all(-1)
            & torch.isfinite(obs.s).flatten(1).all(-1))  # [K]
    centre = cached_constant(
        ("ncc_centre", h_img, w_img, dt),
        lambda: torch.tensor([w_img / 2.0, h_img / 2.0], dtype=dt), dev)
    h = torch.where(live[:, None], obs.h, centre)
    s = torch.where(live[:, None, None], obs.s,
                    (min_gate_px / 3.0) ** 2 * eye2)
    profiling.probe("slam_step.match", dev)  # the warp
    pred_desc = predict_patches(
        cam, state.init_patch, state.init_uv, state.init_cam, state.x[0:7],
        lms_w, h, patch=patch)  # [K, P²]
    profiling.probe("slam_step.match", dev)  # the scan

    # per-feature candidate grid spanning the 3σ box of S (clamped)
    sig_u = torch.sqrt(torch.clamp(s[:, 0, 0], min=1e-9))
    sig_v = torch.sqrt(torch.clamp(s[:, 1, 1], min=1e-9))
    r_u = torch.clamp(3.0 * sig_u, min_gate_px, max_gate_px)
    r_v = torch.clamp(3.0 * sig_v, min_gate_px, max_gate_px)
    lin = grid_unit(grid, dt, dev)
    gv, gu = torch.meshgrid(lin, lin, indexing="ij")
    unit = torch.stack([gu, gv], dim=-1).reshape(-1, 2)  # [G², 2]
    radii = torch.stack([r_u, r_v], dim=-1)  # [K, 2]
    centers = h[:, None, :] + unit[None] * radii[:, None, :]  # [K, G², 2]

    # ellipse + image-bounds gate per candidate
    d = centers - h[:, None, :]
    s_inv, _ = torch.linalg.inv_ex(s + 1e-9 * eye2[None])  # [K, 2, 2]
    mahal = torch.einsum("kca,kab,kcb->kc", d, s_inv, d)
    inb = ((centers[..., 0] > patch) & (centers[..., 0] < w_img - patch - 1)
           & (centers[..., 1] > patch) & (centers[..., 1] < h_img - patch - 1))
    cand_ok = (mahal <= CHI2_2DOF_95) & inb  # [K, G²]

    # candidate patches: every candidate-patch pixel of one feature sits on
    # the outer product of G·P row coordinates × G·P column coordinates
    offs = torch.arange(patch, dtype=dt, device=dev) - (patch - 1) / 2.0
    gp = grid * patch
    # coords[k, c·P + p] = h_k + (lin_c·r_k + off_p), the reference's order
    u_axis = (lin[:, None, None] * r_u[None, None, :]
              + offs[None, :, None]).reshape(gp, k)
    v_axis = (lin[:, None, None] * r_v[None, None, :]
              + offs[None, :, None]).reshape(gp, k)
    u_coords = torch.clamp((h[:, 0][None, :] + u_axis).T, 0.0,
                           w_img - 1.001)  # [K, G·P]
    v_coords = torch.clamp((h[:, 1][None, :] + v_axis).T, 0.0,
                           h_img - 1.001)
    v0f, u0f = torch.floor(v_coords), torch.floor(u_coords)
    dv, du = v_coords - v0f, u_coords - u0f
    v0, u0 = v0f.to(torch.int64), u0f.to(torch.int64)
    # row blend: [K, G·P(v), W]
    rows = (image[v0] * (1.0 - dv)[..., None]
            + image[v0 + 1] * dv[..., None])
    # column blend: [K, G·P(v), G·P(u)]
    cols = u0[:, None, :].expand(k, gp, gp)
    g2 = (torch.gather(rows, 2, cols) * (1.0 - du)[:, None, :]
          + torch.gather(rows, 2, cols + 1) * du[:, None, :])
    vals = g2.reshape(k, grid, patch, grid, patch).permute(0, 1, 3, 2, 4)
    vals = vals.reshape(k, grid * grid, patch * patch)  # c = cv·G + cu
    vals = vals - torch.mean(vals, dim=-1, keepdim=True)
    vals = vals / torch.clamp(torch.linalg.vector_norm(vals, dim=-1,
                                                       keepdim=True), min=1e-8)

    ncc = torch.einsum("kp,kcp->kc", pred_desc, vals)  # [K, G²]
    ncc = torch.where(cand_ok, ncc, -2.0)
    best = torch.argmax(ncc, dim=-1)  # first maximum, as the reference
    best_ncc = torch.gather(ncc, 1, best[:, None])[:, 0]
    z = torch.gather(centers, 1, best[:, None, None].expand(k, 1, 2))[:, 0]

    ic = live & (best_ncc >= ncc_threshold)
    z = torch.where(ic[:, None], z, 0.0)
    if xyz_img is not None:
        chans = xyz_img.permute(2, 0, 1)  # [3, H, W]
        z_xyz = bilinear_sample(chans, z[None].expand(3, k, 2)).T  # [K, 3]
        z_xyz = torch.where(ic[:, None], z_xyz, 0.0)
    else:
        z_xyz = torch.zeros((k, 3), dtype=dt, device=dev)
    return obs._replace(z=z, ic=ic, z_xyz=z_xyz)
