"""Map management: delete / convert / add landmarks in the masked state.

Port of ``pre3_tpu/ekf/map_management.py``:
  delete_features — tracking-ratio, age and invisibility rules; deletion
    is a mask flip + row/col zeroing (zeroed blocks are exact no-ops);
  convert_to_cartesian — linearity-index conversion with the closed-form
    reparameterization Jacobian, in place in the 6-wide slot;
  add_features — new inverse-depth landmarks from unmatched frame
    features with the RGB-D depth prior ρ = 1/‖xyz‖, all adds as one
    batched covariance augmentation written by three strip/block
    scatters.

Candidate selection: "topk" (detector score) or "weighted" (the
reference's Gaussian-center-weighted sampling without replacement, as one
Gumbel top-k; the Gumbel draws are an input or come from a generator).
Every top-k goes through ``stable_topk``: its inputs are full of ties
(bool masks, -inf, -1 scores), and the reference breaks them toward the
lower index.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from pre3_tpu_torch.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu_torch.frontend.patch_warp import extract_raw_patches
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.inverse_depth import (
    conversion_jacobian, inverse_depth_point, inverse_depth_to_cartesian,
    linearity_index,
)
from pre3_tpu_torch.utils.topk import stable_topk
from pre3_tpu_torch.vo.ransac import _draw_gumbel

# ---------------------------------------------------------------------------
# Delete
# ---------------------------------------------------------------------------


def _per_dim(mask: torch.Tensor) -> torch.Tensor:
    """[K] slot mask → [K·6] per-dimension mask. (An expand, not
    ``repeat_interleave``, which some torch versions run through a host
    sync.)"""
    return mask[:, None].expand(-1, LM_DIM).reshape(-1)


def delete_features(
    state: EkfState, step: torch.Tensor,
    min_predicted: int = 5,
    max_age: int = 20,
    max_invisible: int = 20,
    invisible_rule_min_map: int = 20,
) -> EkfState:
    """Deactivate bad landmarks."""
    bad_ratio = (state.times_measured < 0.5 * state.times_predicted) & (
        state.times_predicted > min_predicted)
    too_old = (step - state.init_frame) > max_age
    n_active = torch.sum(state.active)
    lost = (n_active > invisible_rule_min_map) & (
        (step - state.last_visible) > max_invisible)
    drop = state.active & (bad_ratio | too_old | lost)
    return _deactivate(state, drop)


def _deactivate(state: EkfState, drop: torch.Tensor) -> EkfState:
    keep_dims = torch.cat([
        torch.ones(CAM_DIM, dtype=torch.bool, device=drop.device),
        _per_dim(~drop),
    ])
    x = torch.where(keep_dims, state.x, 0.0)
    p = state.p * keep_dims[:, None] * keep_dims[None, :]
    return state._replace(x=x, p=p, active=state.active & ~drop,
                          is_id=state.is_id & ~drop)


# ---------------------------------------------------------------------------
# Inverse-depth → Cartesian conversion
# ---------------------------------------------------------------------------


def convert_to_cartesian(
    state: EkfState, threshold: float = 0.1, max_conversions: int = 16
) -> EkfState:
    """Reparameterize well-localized inverse-depth landmarks (convert
    when 4·σd·cosα/d < 0.1). At most max_conversions slots convert per
    step, and only their [6, D] strips of P are rewritten; a slot past
    the bound converts next frame."""
    k = state.n_landmarks
    dev = state.x.device
    lms = state.landmarks
    rho_idx = CAM_DIM + torch.arange(k, device=dev) * LM_DIM + 5
    sigma_rho = torch.sqrt(torch.clamp(state.p[rho_idx, rho_idx], min=0.0))
    li = linearity_index(lms, sigma_rho, state.x[0:3])
    conv = state.active & state.is_id & (li < threshold) & (lms[:, 5] > 1e-6)

    m = min(max_conversions, k)
    _, sel = stable_topk(conv.to(torch.int32), m)  # converting first
    sel_conv = conv[sel]  # [M]
    # slots selected AND converting this step (the surplus waits a frame)
    did = torch.zeros(k, dtype=torch.bool, device=dev).scatter(0, sel, sel_conv)

    # per-slot 6×6 reparameterization blocks: top 3 rows ∂p/∂y, rest 0
    j3 = conversion_jacobian(lms[sel])  # [M, 3, 6]
    j6 = torch.cat([j3, torch.zeros((m, 3, LM_DIM), dtype=j3.dtype,
                                    device=dev)], dim=1)
    eye6 = torch.eye(LM_DIM, dtype=j3.dtype, device=dev).expand(m, -1, -1)
    blocks = torch.where(sel_conv[:, None, None], j6, eye6)  # [M, 6, 6]

    # J P Jᵀ with J = blockdiag(I, …, B_s, …), as row strips then column
    # strips of the M selected slots only.
    d = CAM_DIM + k * LM_DIM
    rows = (CAM_DIM + sel[:, None] * LM_DIM
            + torch.arange(LM_DIM, device=dev)[None, :]).reshape(-1)  # [M·6]
    # index_select/index_copy, not p[rows] = …: vmap batches these
    p = state.p
    prow = torch.einsum("kab,kbD->kaD", blocks,
                        p.index_select(0, rows).reshape(m, LM_DIM, d))
    p = p.index_copy(0, rows, prow.reshape(m * LM_DIM, d))
    pcol = torch.einsum("kab,Dkb->Dka", blocks,
                        p.index_select(1, rows).reshape(d, m, LM_DIM))
    p = p.index_copy(1, rows, pcol.reshape(d, m * LM_DIM))

    pts = inverse_depth_to_cartesian(lms)  # [K, 3]
    new_lms = torch.where(did[:, None], torch.cat([pts, torch.zeros_like(pts)],
                                                  dim=-1), lms)
    x = torch.cat([state.x[:CAM_DIM], new_lms.reshape(-1)])
    return state._replace(x=x, p=p, is_id=state.is_id & ~did)


# ---------------------------------------------------------------------------
# Add
# ---------------------------------------------------------------------------


def weighted_candidate_choice(
    gumbel: torch.Tensor,  # [Kf]
    uv: torch.Tensor,  # [Kf, 2]
    mask: torch.Tensor,  # [Kf] eligible candidates
    max_adds: int,
    n_cols: float,
    n_rows: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-center-weighted sampling without replacement of max_adds
    candidate indices (weights N(uv; center, diag((W/6)², (H/6)²))), as
    one Gumbel top-k over log-weights. Returns (indices, ok-mask)."""
    cx, cy = n_cols / 2.0, n_rows / 2.0
    sx, sy = n_cols / 6.0, n_rows / 6.0
    logw = -0.5 * (((uv[:, 0] - cx) / sx) ** 2 + ((uv[:, 1] - cy) / sy) ** 2)
    val = torch.where(mask, logw + gumbel, -torch.inf)
    top_val, top_idx = stable_topk(val, max_adds)
    return top_idx, torch.isfinite(top_val)


def add_features(
    cam_model: Camera,
    state: EkfState,
    frame: Features,
    predicted_h: torch.Tensor,  # [K, 2] current predicted landmark pixels
    step: torch.Tensor,
    n_measured: torch.Tensor,
    max_adds: int = 8,
    min_measured: int = 25,
    min_separation_px: float = 10.0,
    std_pxl: float = 1.0,
    depth_sigma: float = 0.01,
    depth_range_quadratic: bool = False,
    depth_range_d0: float = 2.0,
    image: torch.Tensor | None = None,
    sampling: str = "topk",
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> EkfState:
    """Initialize up to ``max_adds`` new inverse-depth landmarks from
    depth-valid, well-separated frame features when tracking support is
    low.

    sampling: "topk" (detector score) or "weighted" (needs ``gumbel``
    [Kf] or a ``generator``; without either it is "topk", as the
    reference is without a key). ``image`` [H, W] records each new
    feature's raw init patch for the warped-patch NCC matcher; without
    it ``init_patch`` is left as it is (descriptor matching)."""
    k = state.n_landmarks
    dev, dt = state.x.device, state.x.dtype
    # more adds than slots can never land: clamp so candidates and free
    # slots pair 1:1
    max_adds = min(max_adds, k)

    # candidate gate: valid, has depth, far from every active landmark's
    # predicted position
    d2map = torch.linalg.vector_norm(
        frame.uv[:, None, :] - predicted_h[None], dim=-1)  # [Kf, K]
    d2map = torch.where(state.active[None], d2map, torch.inf)
    far = torch.amin(d2map, dim=-1) > min_separation_px
    has_depth = torch.linalg.vector_norm(frame.xyz, dim=-1) > 0.2
    cand = frame.valid & has_depth & far
    want = n_measured < min_measured
    if sampling == "weighted" and (gumbel is not None or generator is not None):
        if gumbel is None:
            gumbel = _draw_gumbel(frame.uv.shape[:1], generator, device=dev)
        top_idx, top_ok = weighted_candidate_choice(
            gumbel, frame.uv, cand & want, max_adds,
            n_cols=cam_model.n_cols, n_rows=cam_model.n_rows)
    else:
        score = torch.where(cand & want, frame.score, -1.0)
        top_score, top_idx = stable_topk(score, max_adds)
        top_ok = top_score > 0

    # free slots: inactive, lowest indices first
    slot_order = torch.argsort(state.active.to(torch.int32), stable=True)
    free_slots = slot_order[:max_adds]
    slot_free = ~state.active[free_slots]

    # init-appearance record of the NCC matcher (patch_when_initialized)
    cand_patches = None if image is None else extract_raw_patches(
        image, frame.uv[top_idx], size=state.init_patch.shape[-1])

    # All adds as ONE batched covariance augmentation: strips against the
    # pre-add P plus the explicit new×new cross-covariance Jc_a·Pcc·Jc_bᵀ
    # (the new slots' pre-add rows are zero).
    a = max_adds
    do = top_ok & slot_free  # [A]
    uv_a = frame.uv[top_idx]  # [A, 2]
    xyz_a = frame.xyz[top_idx]  # [A, 3]
    rho0 = 1.0 / torch.clamp(torch.linalg.vector_norm(xyz_a, dim=-1),
                             min=1e-6)  # [A]
    # depth-prior std: σρ = σ_d·ρ², or the hybrid σ_d·max(ρ², 1/d0²)
    d0 = depth_range_d0
    sig_rho = (depth_sigma * torch.clamp(rho0 * rho0, min=1.0 / (d0 * d0))
               if depth_range_quadratic else depth_sigma * rho0 * rho0)

    cam13 = state.x[:CAM_DIM]

    def y_of(c, uv_, rho_):
        return inverse_depth_point(cam_model, uv_, c[0:3], c[3:7], rho_)

    y_a = y_of(cam13, uv_a, rho0)  # [A, 6]
    jc_a = vmap(lambda u, r: jacfwd(lambda c: y_of(c, u, r))(cam13))(
        uv_a, rho0)  # [A, 6, 13]
    juv_a = vmap(lambda u, r: jacfwd(lambda uu: y_of(cam13, uu, r))(u))(
        uv_a, rho0)  # [A, 6, 2]
    jr_a = vmap(lambda u, r: jacfwd(lambda rr: y_of(cam13, u, rr))(r))(
        uv_a, rho0)  # [A, 6]

    # failed adds are exact no-ops: a non-do slot keeps its rows
    y_a = torch.where(do[:, None], y_a, 0.0)
    jc_eff = torch.where(do[:, None, None], jc_a, 0.0)

    pcc = state.p[:CAM_DIM, :CAM_DIM]
    strips = torch.einsum("aij,jD->aiD", jc_eff, state.p[:CAM_DIM, :])
    cross = torch.einsum("aij,jk,blk->aibl", jc_eff, pcc, jc_eff)  # [A,6,A,6]
    noise = (std_pxl**2) * torch.einsum("ail,ajl->aij", juv_a, juv_a) + (
        sig_rho**2)[:, None, None] * torch.einsum("ai,aj->aij", jr_a, jr_a)
    noise = torch.where(do[:, None, None], noise, 0.0)
    diag = torch.eye(a, dtype=torch.bool, device=dev)[:, None, :, None]
    cross = torch.where(diag, cross + noise[:, :, None, :], cross)

    rows = (CAM_DIM + free_slots[:, None] * LM_DIM
            + torch.arange(LM_DIM, device=dev)[None, :]).reshape(-1)  # [A·6]
    # When fewer than max_adds slots are free, free_slots' tail holds
    # ACTIVE slots (do=False there): every scatter writes the original
    # values back outside `do`. The rows are distinct (argsort output).
    do_rep = _per_dim(do)  # [A·6]
    strips_flat = strips.reshape(a * LM_DIM, -1)
    # Scatters as index_copy (out of place, so vmap can batch them).
    p = state.p
    p = p.index_copy(0, rows, torch.where(do_rep[:, None], strips_flat,
                                          p.index_select(0, rows)))
    p = p.index_copy(1, rows, torch.where(do_rep[None, :], strips_flat.T,
                                          p.index_select(1, rows)))
    # new×new cross block only where BOTH endpoints are fresh adds
    strip = p.index_select(0, rows)  # [A·6, D]
    blk = torch.where(do_rep[:, None] & do_rep[None, :],
                      cross.reshape(a * LM_DIM, a * LM_DIM),
                      strip.index_select(1, rows))
    p = p.index_copy(0, rows, strip.index_copy(1, rows, blk))
    x = state.x.index_copy(0, rows, torch.where(
        do_rep, y_a.reshape(-1), state.x.index_select(0, rows)))

    def put(field: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        return field.index_copy(0, free_slots, new)

    do2 = do[:, None]
    if cand_patches is not None:
        state = state._replace(init_patch=put(state.init_patch, torch.where(
            do2[..., None], cand_patches, state.init_patch[free_slots])))
    return state._replace(
        x=x, p=p,
        active=put(state.active, state.active[free_slots] | do),
        is_id=put(state.is_id, torch.where(do, True,
                                           state.is_id[free_slots])),
        desc=put(state.desc, torch.where(do2, frame.desc[top_idx],
                                         state.desc[free_slots])),
        times_predicted=put(state.times_predicted, torch.where(
            do, 0, state.times_predicted[free_slots])),
        times_measured=put(state.times_measured, torch.where(
            do, 0, state.times_measured[free_slots])),
        init_frame=put(state.init_frame, torch.where(
            do, step, state.init_frame[free_slots])),
        last_visible=put(state.last_visible, torch.where(
            do, step, state.last_visible[free_slots])),
        init_uv=put(state.init_uv, torch.where(do2, uv_a,
                                               state.init_uv[free_slots])),
        init_cam=put(state.init_cam, torch.where(
            do2, cam13[0:7][None], state.init_cam[free_slots])),
    )
