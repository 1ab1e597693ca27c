"""The inverse-depth EKF-SLAM step as the configuration defines it,
written plainly with a dense measurement matrix: prediction with the
VO increment as control, map matching by descriptors inside the 3σ
search region, 1-point RANSAC (three matches per hypothesis), the
low-innovation update, the χ² rescue of the rest and its update, and
map management (delete, Cartesian conversion, new landmarks).

Every Jacobian is the derivative of the plain function it belongs to
(``torch.func``); every update is the textbook one, K = P·Hᵀ·S⁻¹ and
Joseph's form of the covariance, with the quaternion renormalised after
it. The state has the program's layout (camera 13 = r, q, v, ω; then 6
per landmark slot), so the check can start from the program's own."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, jacrev, vmap

from port_bench.reference import geometry as geo
from port_bench.reference.vo import gumbel, match, odometry, topk_stable

CAM, LM = 13, 6
CHI2_95_2DOF = 5.9915
UNIT_MOTION = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


class State(NamedTuple):
    """The filter's state, field for field as the program keeps it."""

    x: torch.Tensor  # [D]
    p: torch.Tensor  # [D, D]
    active: torch.Tensor  # [K]
    is_id: torch.Tensor  # [K] inverse depth (else Cartesian)
    desc: torch.Tensor  # [K, 128]
    times_predicted: torch.Tensor
    times_measured: torch.Tensor
    init_frame: torch.Tensor
    last_visible: torch.Tensor
    init_patch: torch.Tensor
    init_uv: torch.Tensor
    init_cam: torch.Tensor


def as_state(fields, dtype) -> State:
    """A state from any tuple of the same fields, floats in ``dtype``."""
    return State(*(f.to(dtype) if f.is_floating_point() else f.clone()
                   for f in fields))


class Settings(NamedTuple):
    """What the step needs of the configuration's ``slam`` block."""

    min_measured: int
    max_update_slots: int
    match_ratio: float
    vo_batch: int = 512
    ransac_batch: int = 256
    max_adds: int = 8
    dt: float = 0.1

    @staticmethod
    def of(slam: dict) -> "Settings":
        known = {k: v for k, v in slam.items() if k in Settings._fields}
        return Settings(**known)


def initial_state(k: int, desc_dim: int, dtype, device) -> State:
    """Zero pose, ω = 1e-15; P = diag(1e-7 on the pose, 0.025² on v and ω)."""
    d = CAM + LM * k
    x = torch.zeros(d, dtype=dtype, device=device)
    x[3] = 1.0
    x[10:13] = 1e-15
    diag = torch.zeros(d, dtype=dtype, device=device)
    diag[:7] = 1e-7
    diag[7:13] = 0.025 ** 2
    zi = torch.zeros(k, dtype=torch.int32, device=device)
    zb = torch.zeros(k, dtype=torch.bool, device=device)
    return State(x, torch.diag(diag), zb, zb.clone(),
                 torch.zeros(k, desc_dim, dtype=dtype, device=device),
                 zi, zi.clone(), zi.clone(), zi.clone(),
                 torch.zeros(k, 21, 21, dtype=dtype, device=device),
                 torch.zeros(k, 2, dtype=dtype, device=device),
                 torch.zeros(k, 7, dtype=dtype, device=device))


@functools.cache
def control_noise(dtype, device) -> torch.Tensor:
    """[7, 7] noise of the control u = [dX, dq]: (0.01/3)² on dX, and
    Euler noise 0.12°·[1, 0.1, 1] through ∂q/∂e."""
    e = 0.12 * math.pi / 180 * torch.tensor([1.0, 0.1, 1.0],
                                            dtype=torch.float64)
    qe = jacfwd(geo.euler_quaternion)(e)
    pn = torch.zeros(7, 7, dtype=torch.float64)
    pn[:3, :3] = torch.eye(3, dtype=torch.float64) * (0.01 / 3) ** 2
    pn[3:, 3:] = qe @ torch.diag(e ** 2) @ qe.T
    return pn.to(dtype=dtype, device=device)


def renormalise(x, p):
    """q ← q/|q| and P ← J·P·Jᵀ with J the normalisation's Jacobian."""
    j = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    j[3:7, 3:7] = jacfwd(geo.normalised)(x[3:7])
    x = torch.cat([x[:3], geo.normalised(x[3:7]), x[7:]])
    return x, j @ p @ j.T


def symmetric(p):
    return 0.5 * (p + p.T)


def predict(st: State, u, pn) -> State:
    """Camera r' = r + R(q)·dX, q' = q ⊗ dq, v and ω carried; F and G the
    transition's Jacobians, P' = Φ·P·Φᵀ + blockdiag(G·Pn·Gᵀ, 0) with the
    renormalisation folded into Φ."""
    d = st.x.shape[0]

    def move(cam, uu):
        return torch.cat([cam[:3] + geo.rotate(cam[3:7], uu[:3]),
                          geo.hamilton(cam[3:7], uu[3:7]), cam[7:13]])

    cam = st.x[:CAM]
    new = move(cam, u)
    f = jacfwd(move, argnums=0)(cam, u)
    g = jacfwd(move, argnums=1)(cam, u)
    jn = torch.eye(CAM, dtype=cam.dtype, device=cam.device)
    jn[3:7, 3:7] = jacfwd(geo.normalised)(new[3:7])
    phi = torch.eye(d, dtype=cam.dtype, device=cam.device)
    phi[:CAM, :CAM] = jn @ f
    q = torch.zeros(d, d, dtype=cam.dtype, device=cam.device)
    q[:CAM, :CAM] = jn @ g @ pn @ g.T @ jn.T
    p = symmetric(phi @ st.p @ phi.T + q)
    x = torch.cat([new[:3], geo.normalised(new[3:7]), new[7:13], st.x[CAM:]])
    return st._replace(x=x, p=p)


class Measured(NamedTuple):
    h: torch.Tensor  # [K, 2] predicted pixels
    jac: torch.Tensor  # [K, 2, D] dense rows of H
    s: torch.Tensor  # [K, 2, 2] innovation covariances
    visible: torch.Tensor  # [K]


def slot_pixels(x: torch.Tensor, is_id: torch.Tensor) -> torch.Tensor:
    """[..., K, 2] distorted pixels of every slot under state(s) x."""
    cam = x[..., :CAM]
    lms = x[..., CAM:].reshape(*x.shape[:-1], -1, LM)
    return geo.pixel(geo.camera_direction(cam[..., None, :], lms, is_id))


def measure(st: State) -> Measured:
    """h, the dense H (∂h/∂x, zero on a Cartesian slot's last three
    entries), S_i = H_i·P·H_iᵀ + I and the visibility gate (in front,
    within 60° on each axis, inside the image, active)."""
    k = st.active.shape[0]
    cam, lms = st.x[:CAM], st.x[CAM:].reshape(k, LM)

    def h_of(c, lm, iid):
        return geo.pixel(geo.camera_direction(c, lm, iid))

    h = h_of(cam, lms, st.is_id)
    hc = jacfwd(h_of, argnums=0)(cam, lms, st.is_id)  # [K, 2, 13]
    hl = vmap(jacrev(h_of, argnums=1), in_dims=(None, 0, 0))(
        cam, lms, st.is_id)  # [K, 2, 6]
    hl = torch.where(st.is_id[:, None, None]
                     | (torch.arange(LM, device=hl.device) < 3), hl, 0.0)
    jac = torch.zeros(k, 2, st.x.shape[0], dtype=h.dtype, device=h.device)
    jac[:, :, :CAM] = hc
    slot = torch.arange(k, device=h.device)
    cols = CAM + LM * slot[:, None] + torch.arange(LM, device=h.device)
    jac[slot[:, None, None], torch.arange(2, device=h.device)[None, :, None],
        cols[:, None, :]] = hl
    ph = st.p @ jac.reshape(2 * k, -1).T  # [D, 2K]
    s = torch.einsum("kad,dkb->kab", jac, ph.reshape(-1, k, 2)) + torch.eye(
        2, dtype=h.dtype, device=h.device)
    d = geo.camera_direction(cam, lms, st.is_id)
    ax = torch.rad2deg(torch.atan2(d[:, 0], d[:, 2])).abs()
    ay = torch.rad2deg(torch.atan2(d[:, 1], d[:, 2])).abs()
    vis = ((d[:, 2] > 0) & (ax < 60) & (ay < 60) & (h[:, 0] > 0)
           & (h[:, 0] < geo.COLS - 1) & (h[:, 1] > 0)
           & (h[:, 1] < geo.ROWS - 1) & st.active)
    # rows of slots out of view are never used; zeroed, a far slot's
    # huge derivatives cannot reach a product
    jac = torch.where(vis[:, None, None], jac, 0.0)
    return Measured(h, jac, s, vis)


def ransac(st: State, m: Measured, z, ic, g, pool_size: int,
           per_hypothesis: int = 3) -> torch.Tensor:
    """The low-innovation inliers: hypotheses of three matches drawn from
    the pool (every slot where ``pool_size`` holds them all; else the
    first ``pool_size`` slots with a match before the rest, by index),
    one match per hypothesis unless more than three
    exist), each the state after its matches' update, the support of
    each the matches reprojected within a pixel under it; the first
    best wins."""
    k = ic.shape[0]
    pool = (topk_stable(ic.to(torch.int32), pool_size) if pool_size < k
            else torch.arange(k, device=ic.device))
    ic_pool = ic[pool]
    logits = torch.where(ic_pool, 0.0, -math.inf).to(g.dtype)
    pick = topk_stable(logits[None] + g, per_hypothesis)  # [B, 3]
    n_use = per_hypothesis if int(ic.sum()) > per_hypothesis else 1
    use = (torch.arange(per_hypothesis, device=z.device) < n_use) & ic_pool[pick]
    slots = pool[pick]  # [B, 3]
    rows = (2 * slots[..., None] + torch.arange(2, device=z.device)).reshape(
        g.shape[0], -1)  # [B, 6]
    use2 = use[..., None].expand(-1, -1, 2).reshape(g.shape[0], -1)
    h_all = m.jac.reshape(2 * k, -1)
    ph = st.p @ h_all.T  # [D, 2K]
    s_all = h_all @ ph
    eye = torch.eye(rows.shape[1], dtype=z.dtype, device=z.device)
    s_b = torch.where(use2[:, :, None] & use2[:, None, :],
                      s_all[rows[:, :, None], rows[:, None, :]], 0.0) + eye
    nu = torch.where(use2, (z - m.h).reshape(-1)[rows], 0.0)
    y = torch.linalg.solve(s_b, nu[..., None])[..., 0]  # [B, 6]
    dx = torch.einsum("dbr,br->bd", ph[:, rows], torch.where(use2, y, 0.0))
    px = slot_pixels(st.x[None] + dx, st.is_id)  # [B, K, 2]
    inl = (torch.linalg.vector_norm(z[None] - px, dim=-1) < 1.0) & ic
    best = int(torch.argmax(inl.sum(-1)))
    return inl[best] & ic.any()


def update(st: State, m: Measured, z, use, max_slots: int) -> State:
    """The Kalman update on the measurements of ``use`` (the first
    ``max_slots`` of them by slot index), unit pixel noise, Joseph form,
    then the quaternion renormalised."""
    idx = torch.nonzero(use).flatten()[:max_slots]
    hm = m.jac[idx].reshape(-1, st.x.shape[0])
    nu = (z - m.h)[idx].reshape(-1)
    eye_m = torch.eye(hm.shape[0], dtype=hm.dtype, device=hm.device)
    s = hm @ st.p @ hm.T + eye_m
    gain = torch.linalg.solve(s, hm @ st.p).T  # P·Hᵀ·S⁻¹
    x = st.x + gain @ nu
    a = torch.eye(st.x.shape[0], dtype=hm.dtype, device=hm.device) - gain @ hm
    p = symmetric(a @ st.p @ a.T + gain @ gain.T)
    x, p = renormalise(x, p)
    return st._replace(x=x, p=symmetric(p))


def deactivate(st: State, drop) -> State:
    keep = torch.cat([torch.ones(CAM, dtype=torch.bool, device=drop.device),
                      (~drop)[:, None].expand(-1, LM).reshape(-1)])
    return st._replace(x=torch.where(keep, st.x, 0.0),
                       p=torch.where(keep[:, None] & keep[None, :], st.p, 0.0),
                       active=st.active & ~drop, is_id=st.is_id & ~drop)


def delete(st: State, step: int) -> State:
    """Drop a landmark measured in under half of more than five
    predictions, older than 10000 frames, or, with more than 20 active,
    unmatched for more than 20 frames."""
    tp, tm = st.times_predicted, st.times_measured
    bad = (tm < 0.5 * tp) & (tp > 5)
    old = (step - st.init_frame) > 10_000
    lost = (st.active.sum() > 20) & ((step - st.last_visible) > 20)
    return deactivate(st, st.active & (bad | old | lost))


def convert(st: State, limit: int = 16) -> State:
    """Inverse-depth slots whose linearity index 4·σ_d·cos α/d is under
    0.1 (and ρ > 1e-6) become Cartesian, the first ``limit`` by index;
    the slot's covariance goes through ∂p/∂y (rows 4–6 zero)."""
    k = st.active.shape[0]
    lms = st.x[CAM:].reshape(k, LM)
    rho_var = torch.diagonal(st.p)[CAM:].reshape(k, LM)[:, 5]
    sd = torch.sqrt(rho_var.clamp(min=0)) / (lms[:, 5] ** 2).clamp(min=1e-12)
    pts = geo.landmark_point(lms)
    d1, d2 = pts - lms[:, :3], pts - st.x[:3]
    n1, n2 = (torch.linalg.vector_norm(v, dim=-1) for v in (d1, d2))
    cos_a = (d1 * d2).sum(-1) / (n1 * n2).clamp(min=1e-12)
    index = 4 * sd * cos_a / n2.clamp(min=1e-12)
    conv = st.active & st.is_id & (index < 0.1) & (lms[:, 5] > 1e-6)
    slots = torch.nonzero(conv).flatten()[:limit]
    j = torch.eye(st.x.shape[0], dtype=st.x.dtype, device=st.x.device)
    x = st.x.clone()
    if slots.numel():
        rows = CAM + LM * slots[:, None] + torch.arange(LM, device=x.device)
        block = torch.zeros(len(slots), LM, LM, dtype=x.dtype, device=x.device)
        block[:, :3] = vmap(jacrev(geo.landmark_point))(lms[slots])
        j[rows[:, :, None], rows[:, None, :]] = block
        x[rows] = torch.cat([pts[slots], torch.zeros_like(pts[slots])], -1)
    done = torch.zeros(k, dtype=torch.bool, device=st.x.device)
    done[slots] = True
    return st._replace(x=x, p=j @ st.p @ j.T, is_id=st.is_id & ~done)


def add(st: State, frame, h_gate, step: int, n_measured: int,
        max_adds: int, min_measured: int) -> State:
    """While under ``min_measured`` matches were measured, up to
    ``max_adds`` new inverse-depth landmarks from the frame's highest-
    scoring features with depth over 0.2 m and over 10 px from every
    active landmark's prediction, into the free slots in index order:
    ρ = 1/|xyz|, σ_ρ = 0.01·max(ρ², 1/1.5²), unit pixel noise; the new
    rows are ∂y/∂camera times the camera's."""
    k = st.active.shape[0]
    dmap = torch.linalg.vector_norm(frame.uv[:, None] - h_gate[None], dim=-1)
    dmap = torch.where(st.active[None], dmap, math.inf)
    cand = frame.valid & (torch.linalg.vector_norm(frame.xyz, dim=-1) > 0.2) & (
        dmap.amin(-1) > 10.0)
    if not n_measured < min_measured:
        cand = torch.zeros_like(cand)
    score = torch.where(cand, frame.score, -1.0)
    top = topk_stable(score, max_adds)
    free = torch.sort(st.active.to(torch.int32), stable=True).indices[:max_adds]
    ok = (score[top] > 0) & ~st.active[free]
    fi, slot = top[ok], free[ok]
    if not fi.numel():
        return st
    cam = st.x[:CAM]

    def y_of(c, uv, rho):
        return geo.landmark_from_pixel(uv, c[:3], c[3:7], rho)

    uv, xyz = frame.uv[fi], frame.xyz[fi]
    rho = 1.0 / torch.linalg.vector_norm(xyz, dim=-1).clamp(min=1e-6)
    sig = 0.01 * torch.clamp(rho * rho, min=1 / 1.5 ** 2)
    jc = vmap(jacfwd(y_of, argnums=0), in_dims=(None, 0, 0))(cam, uv, rho)
    juv = vmap(jacfwd(y_of, argnums=1), in_dims=(None, 0, 0))(cam, uv, rho)
    jr = vmap(jacfwd(y_of, argnums=2), in_dims=(None, 0, 0))(cam, uv, rho)
    d = st.x.shape[0]
    rows = CAM + LM * slot[:, None] + torch.arange(LM, device=cam.device)
    a = torch.eye(d, dtype=cam.dtype, device=cam.device)
    a[rows.reshape(-1)] = 0
    a[rows[:, :, None], torch.arange(CAM, device=cam.device)] = jc
    noise = torch.zeros(d, d, dtype=cam.dtype, device=cam.device)
    noise[rows[:, :, None], rows[:, None, :]] = (
        juv @ juv.transpose(-1, -2)
        + sig[:, None, None] ** 2 * jr[:, :, None] * jr[:, None, :])
    x = st.x.clone()
    x[rows] = y_of(cam, uv, rho)

    def put(field, value):
        out = field.clone()
        out[slot] = value
        return out

    return st._replace(
        x=x, p=symmetric(a @ st.p @ a.T + noise),
        active=put(st.active, True), is_id=put(st.is_id, True),
        desc=put(st.desc, frame.desc[fi].to(st.desc.dtype)),
        times_predicted=put(st.times_predicted, 0),
        times_measured=put(st.times_measured, 0),
        init_frame=put(st.init_frame, step),
        last_visible=put(st.last_visible, step),
        init_uv=put(st.init_uv, uv.to(st.init_uv.dtype)),
        init_cam=put(st.init_cam, cam[:7].to(st.init_cam.dtype)))


def bootstrap(frame, k: int, s: Settings, dtype) -> State:
    """The filter started on frame 0: up to 4·max_adds landmarks."""
    st = initial_state(k, frame.desc.shape[-1], dtype, frame.uv.device)
    return add(st, frame, measure(st).h, 0, 0, 4 * s.max_adds, s.min_measured)


def draw(s: Settings, n_feats: int, k: int, gen: torch.Generator, device):
    """One step's draws, in the order the step takes them: VO RANSAC
    [vo_batch, features], 1-point RANSAC [ransac_batch, pool]."""
    pool = min(s.max_update_slots, k) if s.max_update_slots > 0 else k
    return (gumbel((s.vo_batch, n_feats), gen, device),
            gumbel((s.ransac_batch, pool), gen, device))


def step(st: State, prev, cur, index: int, s: Settings,
         gen: torch.Generator) -> State:
    """Step ``index``: from the filter after frame index − 1 (``prev``'s
    features) to the filter after frame ``index`` (``cur``'s)."""
    dtype, dev = st.x.dtype, st.x.device
    g_vo, g_r = draw(s, cur.uv.shape[0], st.active.shape[0], gen, dev)
    k = st.active.shape[0]
    pool = min(s.max_update_slots, k) if s.max_update_slots > 0 else k
    slots = s.max_update_slots if s.max_update_slots > 0 else k

    # 1. prediction with the VO increment as control
    vo = odometry(prev, cur, g_vo)
    q_before = st.x[3:7]
    if bool(vo.ok):
        u = torch.cat([vo.t, vo.q])
        w = geo.quaternion_axis_angle(vo.q)
        jq = jacfwd(geo.axis_angle_quaternion)(w)
        jm = torch.zeros(7, 6, dtype=dtype, device=dev)
        jm[:3, :3] = torch.eye(3, dtype=dtype, device=dev)
        jm[3:, 3:] = jq
        pn = jm @ vo.cov @ jm.T + control_noise(dtype, dev)
    else:
        u = torch.tensor(UNIT_MOTION, dtype=dtype, device=dev)
        pn = 1e-3 * torch.eye(7, dtype=dtype, device=dev)
    st = predict(st, u, pn)
    if bool(vo.ok):
        x = st.x.clone()
        x[7:10] = geo.rotate(q_before, vo.t) / s.dt
        x[10:13] = geo.quaternion_axis_angle(vo.q) / s.dt
        st = st._replace(x=x)

    # 2. matching of the map inside its search regions
    m = measure(st)
    gate = torch.clamp(3 * torch.sqrt(torch.maximum(
        m.s[:, 0, 0], m.s[:, 1, 1]).clamp(min=1e-9)), max=40.0)
    mt = match(st.desc, cur.desc, m.visible, cur.valid, s.match_ratio)
    z = cur.uv[mt.index]
    ic = mt.accepted & m.visible & (
        torch.linalg.vector_norm(z - m.h, dim=-1) <= gate)
    z = torch.where(ic[:, None], z, 0.0)
    st = st._replace(desc=torch.where(ic[:, None], cur.desc[mt.index],
                                      st.desc))

    # 3. 1-point RANSAC, its update, the rescue and its update
    li = ransac(st, m, z, ic, g_r, pool)
    st = update(st, m, z, li, slots)
    m2 = measure(st)
    nu = z - m2.h
    det = m2.s[:, 0, 0] * m2.s[:, 1, 1] - m2.s[:, 0, 1] * m2.s[:, 1, 0]
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    chi2 = (m2.s[:, 1, 1] * nu[:, 0] ** 2 - (m2.s[:, 0, 1] + m2.s[:, 1, 0])
            * nu[:, 0] * nu[:, 1] + m2.s[:, 0, 0] * nu[:, 1] ** 2) / det
    hi = ic & ~li & (chi2 < CHI2_95_2DOF)
    st = update(st, m2, z, hi, slots)

    # 4. bookkeeping and map management
    measured = li | hi
    st = st._replace(
        times_predicted=st.times_predicted + m.visible.to(torch.int32),
        times_measured=st.times_measured + measured.to(torch.int32),
        last_visible=torch.where(ic, index, st.last_visible).to(torch.int32))
    st = delete(st, index)
    st = convert(st)
    return add(st, cur, m2.h, index, int(measured.sum()), s.max_adds,
               s.min_measured)
