"""Faithful single-thread NumPy port of the reference per-frame loop.

Two jobs, neither on any production path:

1. **Baseline denominator** (BASELINE.md): the reference MATLAB pipeline
   publishes no frames/s, so the speedup claim needs a measured stand-in.
   `run_reference_slam` reproduces the reference's per-frame control flow
   (mono_slam.m:113-435) at loop-level fidelity — sequential adaptive
   RANSAC everywhere the reference iterates, per-feature Python loops
   where the reference has MATLAB `for` loops, dense EKF algebra — and
   `tools/measure_baseline.py` times it on this host.

2. **Statistical-parity oracle** (SURVEY §7.3): the TPU engine replaces
   the adaptive sequential RANSAC loops with fixed-budget batched draws;
   `adaptive_ransac_vo` (ransac_dr_ye.m / vodometry_dr_ye.m:150-199) and
   `adaptive_ransac_hypotheses` (ransac_hypotheses.m:27-86) are the
   reference-faithful comparators used by tests/test_ransac_parity.py to
   verify the inlier-set recovery and support distributions match.

Cost-fidelity ground rules (documented so the denominator is defensible):
- numpy-vectorized where the reference calls C MEX or vectorized MATLAB
  (SIFT kernels `sift/*.c`, support counting
  `compute_hypothesis_support_fast.m:35-110`, `RANSAC_CALC_VER2.m:121-125`);
- Python loops where the reference has interpreted MATLAB loops (the
  RANSAC iteration loops, per-feature matching `matching_sift_based.m`,
  per-feature Jacobians `calculate_derivatives.m:32-59`, map management);
- measurement Jacobians by per-feature central differences instead of the
  reference's ~600 lines of hand chain rule (`calculate_Hi_*`) — a few
  dozen scalar-graph evaluations per feature, comparable interpreted-op
  count, and generous to the reference (FD is if anything slower).

This file deliberately contains NO jax: it is the thing the engine is
measured against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
from scipy.ndimage import gaussian_filter

# ---------------------------------------------------------------------------
# Camera model (initialize_cam.m:64-77) and quaternion utilities — numpy
# mirrors of pre3_tpu.geometry so parity tests compare like with like.
# ---------------------------------------------------------------------------

F, CX, CY = 250.57731, 91.69, 72.27
K1, K2 = -0.84656, 0.53701
N_ROWS, N_COLS = 144, 176


def project_np(p_cam: np.ndarray) -> np.ndarray:
    """Camera point(s) [..., 3] → distorted pixel (hu + distort_fm)."""
    z = p_cam[..., 2]
    z = np.where(np.abs(z) < 1e-9, 1e-9, z)
    xu = p_cam[..., 0] / z
    yu = p_cam[..., 1] / z
    r2 = xu * xu + yu * yu
    d = 1.0 + K1 * r2 + K2 * r2 * r2
    return np.stack([CX + F * xu * d, CY + F * yu * d], axis=-1)


def undistort_np(uvd: np.ndarray) -> np.ndarray:
    """Distorted → undistorted pixel (undistort_fm_my_version.m:62-71)."""
    xd = (uvd[..., 0] - CX) / F
    yd = (uvd[..., 1] - CY) / F
    rd = np.sqrt(xd * xd + yd * yd)
    ru = rd / (1.0 + K1 * rd * rd + K2 * rd**4)
    for _ in range(10):
        f1 = ru + K1 * ru**3 + K2 * ru**5 - rd
        ru = ru - f1 / (1.0 + 3 * K1 * ru * ru + 5 * K2 * ru**4)
    d = 1.0 + K1 * ru * ru + K2 * ru**4
    d = np.where(d == 0, 1.0, d)
    return np.stack([CX + F * xd / d, CY + F * yd / d], axis=-1)


def qprod_np(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def q2r_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def ray_np(theta, phi):
    cp = np.cos(phi)
    return np.array([cp * np.sin(theta), -np.sin(phi), cp * np.cos(theta)])


# ---------------------------------------------------------------------------
# SIFT frontend (sift/sift_vedal.m:135-323 pipeline; the C MEX kernels —
# siftlocalmax/siftrefinemx/siftormx/siftdescriptor — become vectorized
# numpy, which is the cost-faithful proxy for compiled kernels).
# ---------------------------------------------------------------------------


def sift_numpy(img: np.ndarray, n_octaves: int = 3, s: int = 3,
               peak_thresh: float = 0.005, max_kp: int = 200):
    """Returns (uv [N,2], desc [N,128]). Structure follows gaussianss.m +
    sift_vedal.m:200-323: per octave build S+3 Gaussian levels, DoG,
    3x3x3 local max, orientation histogram, 4x4x8 descriptor."""
    img = img.astype(np.float64)
    img = img / max(img.max(), 1e-9)
    uvs, descs = [], []
    base = gaussian_filter(img, 0.5)
    for o in range(n_octaves):
        levels = [base]
        sig_prev = 1.6
        for i in range(s + 2):
            sig = 1.6 * (2 ** ((i + 1) / s))
            add = math.sqrt(max(sig**2 - sig_prev**2, 1e-6))
            levels.append(gaussian_filter(levels[-1], add))
            sig_prev = sig
        stack = np.stack(levels)  # [S+3, H, W]
        dog = stack[1:] - stack[:-1]  # [S+2, H, W]
        # 3D local extrema (siftlocalmax.c): vectorized 26-neighbor test
        c = dog[1:-1, 1:-1, 1:-1]
        is_max = np.ones_like(c, bool)
        is_min = np.ones_like(c, bool)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dz == dy == dx == 0:
                        continue
                    nb = dog[1 + dz:dog.shape[0] - 1 + dz,
                             1 + dy:dog.shape[1] - 1 + dy,
                             1 + dx:dog.shape[2] - 1 + dx]
                    is_max &= c > nb
                    is_min &= c < nb
        kp = np.argwhere((is_max | is_min) & (np.abs(c) > peak_thresh))
        # gradient images for orientation/descriptor (siftormx.c uses the
        # level nearest the keypoint scale)
        gy, gx = np.gradient(stack[s // 2 + 1])
        mag = np.sqrt(gx * gx + gy * gy)
        ang = np.arctan2(gy, gx)
        scale = 2.0**o
        for sl, r, cc in kp[:max_kp]:
            r, cc = r + 1, cc + 1
            if not (8 <= r < img.shape[0] - 8 and 8 <= cc < img.shape[1] - 8):
                continue
            # orientation: 36-bin histogram in a 9x9 window (siftormx.c)
            w_mag = mag[r - 4:r + 5, cc - 4:cc + 5].ravel()
            w_ang = ang[r - 4:r + 5, cc - 4:cc + 5].ravel()
            hist, _ = np.histogram(w_ang, bins=36, range=(-np.pi, np.pi),
                                   weights=w_mag)
            ori = (np.argmax(hist) + 0.5) / 36 * 2 * np.pi - np.pi
            # descriptor: 4x4 spatial x 8 orientation bins over 16x16
            # (siftdescriptor.c), rotated to the keypoint orientation
            pm = mag[r - 8:r + 8, cc - 8:cc + 8]
            pa = (ang[r - 8:r + 8, cc - 8:cc + 8] - ori) % (2 * np.pi)
            cell_r = np.repeat(np.arange(4), 4)
            d = np.zeros((4, 4, 8))
            ob = np.minimum((pa / (2 * np.pi) * 8).astype(int), 7)
            for i4 in range(4):
                for j4 in range(4):
                    bm = pm[i4 * 4:(i4 + 1) * 4, j4 * 4:(j4 + 1) * 4]
                    bo = ob[i4 * 4:(i4 + 1) * 4, j4 * 4:(j4 + 1) * 4]
                    d[i4, j4] = np.bincount(bo.ravel(), bm.ravel(), 8)
            d = d.ravel()
            n = np.linalg.norm(d)
            if n < 1e-9:
                continue
            d = np.minimum(d / n, 0.2)
            d /= max(np.linalg.norm(d), 1e-9)
            uvs.append([cc * scale, r * scale])
            descs.append(d)
        _ = cell_r
        base = base[::2, ::2]
    if not uvs:
        return np.zeros((0, 2)), np.zeros((0, 128))
    return np.asarray(uvs, np.float64), np.asarray(descs, np.float64)


def siftmatch_numpy(d1: np.ndarray, d2: np.ndarray, thresh: float = 1.5):
    """Brute-force NN with ratio acceptance on squared distances
    (sift/siftmatch.c:93-126, default thresh 1.5). Returns [M, 2] index
    pairs. The O(N1·N2) distance matrix is one BLAS call — the proxy for
    the C loop."""
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), int)
    dist2 = (
        np.sum(d1 * d1, 1)[:, None] + np.sum(d2 * d2, 1)[None, :]
        - 2.0 * d1 @ d2.T
    )
    out = []
    for i in range(len(d1)):  # per-keypoint loop as in siftmatch.c
        row = dist2[i]
        j = int(np.argmin(row))
        best = row[j]
        row2 = row.copy()
        row2[j] = np.inf
        if best * thresh < row2.min():
            out.append((i, j))
    return np.asarray(out, int).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Adaptive sequential RANSAC VO (ransac_dr_ye.m + vodometry_dr_ye.m:150-199)
# ---------------------------------------------------------------------------


def kabsch_np(p1: np.ndarray, p2: np.ndarray):
    """find_transform_matrix.m:2-43: SVD alignment p1 ≈ R p2 + t with the
    det=−1 reflection fix."""
    c1, c2 = p1.mean(0), p2.mean(0)
    h = (p2 - c2).T @ (p1 - c1)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return r, c1 - r @ c2


def adaptive_ransac_vo(
    p1: np.ndarray,  # [N, 3] frame-1 camera points
    p2: np.ndarray,  # [N, 3] matched frame-2 points
    rng: np.random.Generator,
    max_iter: int = 700,
    sample_size: int = 4,
    epsilon: float = 0.01,
):
    """The reference's sequential adaptive VO RANSAC: ≤700 iterations
    (vodometry_dr_ye.m:162), 4-point hypotheses, support gate
    d² < 0.001·dist(min-Z point) (ransac_dr_ye.m:23,72), adaptation
    n_iter = 5·ceil(log ε / log(1 − (c/n)^4)) (vodometry_dr_ye.m:177),
    best = max support, refit on the support set.

    Returns (R, t, inliers [N] bool, n_iters_run)."""
    n = len(p1)
    if n < sample_size:
        return np.eye(3), np.zeros(3), np.zeros(n, bool), 0
    nrm = np.linalg.norm(p2, axis=1)
    far = nrm > 0.4
    zsel = p2[far, 2] if far.any() else p2[:, 2]
    psel = p2[far] if far.any() else p2
    dist = np.linalg.norm(psel[np.argmin(zsel)])
    thr = 0.001 * dist
    n_iter = min(max_iter, math.comb(n, sample_size))
    best_support, best_inl = 0, np.zeros(n, bool)
    it = 0
    while it < n_iter:  # sequential, data-dependent trip count
        idx = rng.choice(n, size=sample_size, replace=False)
        r, t = kabsch_np(p1[idx], p2[idx])
        resid2 = np.sum((p2 @ r.T + t - p1) ** 2, axis=1)
        inl = resid2 < thr
        c = int(inl.sum())
        if c > best_support:
            best_support, best_inl = c, inl
            ratio = c / n
            if 0 < ratio < 1:
                n_iter = min(
                    n_iter,
                    5 * math.ceil(math.log(epsilon)
                                  / math.log(1 - ratio**sample_size)),
                )
        it += 1
    if best_support < 3:
        return np.eye(3), np.zeros(3), np.zeros(n, bool), it
    r, t = kabsch_np(p1[best_inl], p2[best_inl])
    return r, t, best_inl, it


# ---------------------------------------------------------------------------
# Dense EKF (mono_slam.m loop body) — numpy state mirrors @ekf_filter
# ---------------------------------------------------------------------------


@dataclass
class RefFeature:
    """features_info entry (add_feature_to_info_vector_my_version_sift.m)."""

    offset: int  # position of the parameter block in x
    dim: int  # 6 inverse-depth, 3 cartesian
    desc: np.ndarray
    times_predicted: int = 0
    times_measured: int = 0
    init_frame: int = 0
    last_visible: int = 0
    h: np.ndarray | None = None
    H: np.ndarray | None = None  # [2, D]
    S: np.ndarray | None = None
    z: np.ndarray | None = None
    ic: bool = False


@dataclass
class RefFilter:
    x: np.ndarray
    p: np.ndarray
    features: list[RefFeature] = field(default_factory=list)
    std_z: float = 1.0


def h_of_feature(x: np.ndarray, feat: RefFeature) -> np.ndarray:
    """Measurement model of one feature (hi_inverse_depth.m /
    hi_cartesian.m)."""
    r_wc, q_wc = x[0:3], x[3:7]
    rot = q2r_np(q_wc)
    y = x[feat.offset:feat.offset + feat.dim]
    if feat.dim == 6:
        hrl = rot.T @ (y[5] * (y[0:3] - r_wc) + ray_np(y[3], y[4]))
    else:
        hrl = rot.T @ (y - r_wc)
    return project_np(hrl)


def feature_jacobian(x: np.ndarray, feat: RefFeature,
                     eps: float = 1e-5) -> np.ndarray:
    """[2, D] measurement Jacobian by central differences over the camera
    pose (7) and feature block (reference: analytic chain rule,
    calculate_Hi_inverse_depth_my_version.m:27-192; FD here is the
    cost-comparable interpreted stand-in — see module docstring)."""
    d = len(x)
    h_rows = np.zeros((2, d))
    cols = list(range(7)) + list(range(feat.offset, feat.offset + feat.dim))
    for c in cols:
        xp = x.copy()
        xm = x.copy()
        xp[c] += eps
        xm[c] -= eps
        h_rows[:, c] = (h_of_feature(xp, feat) - h_of_feature(xm, feat)) / (
            2 * eps
        )
    return h_rows


def predict_camera_measurements(flt: RefFilter) -> None:
    """predict_camera_measurements.m + calculate_derivatives.m: per-feature
    loop computing h, H, S (search_IC_matches.m:33-44)."""
    for feat in flt.features:
        h = h_of_feature(flt.x, feat)
        u, v = h
        if not (0 < u < N_COLS - 1 and 0 < v < N_ROWS - 1):
            feat.h, feat.ic = None, False
            continue
        hrows = feature_jacobian(flt.x, feat)
        s = hrows @ flt.p @ hrows.T + flt.std_z**2 * np.eye(2)
        feat.h, feat.H, feat.S = h, hrows, s
        feat.times_predicted += 1


def match_features(flt: RefFilter, uv: np.ndarray, desc: np.ndarray) -> None:
    """matching_sift_based.m:27-206: per-feature descriptor match gated by
    the 3√S search region (fallback 40 px)."""
    for feat in flt.features:
        feat.ic, feat.z = False, None
        if feat.h is None or len(desc) == 0:
            continue
        dist2 = np.sum((desc - feat.desc) ** 2, axis=1)
        j = int(np.argmin(dist2))
        best = dist2[j]
        d2 = dist2.copy()
        d2[j] = np.inf
        if not best * 1.5 < d2.min():
            continue
        gate = min(3.0 * math.sqrt(max(feat.S[0, 0], feat.S[1, 1])), 40.0)
        if np.linalg.norm(uv[j] - feat.h) <= gate:
            feat.z = uv[j]
            feat.ic = True
            feat.desc = desc[j]


def adaptive_ransac_hypotheses(
    flt: RefFilter,
    rng: np.random.Generator,
    max_hyp: int = 1000,
    p_free: float = 0.99,
) -> list[int]:
    """ransac_hypotheses.m:27-86: sequential adaptive loop; each iteration
    draws 1 or 3 IC matches (select_random_match.m:47-51), applies a
    partial Kalman update on the PRIOR, counts low-innovation support by
    reprojecting all IC features (compute_hypothesis_support_fast.m,
    vectorized there and here). Returns indices of li-inlier features."""
    ic_idx = [i for i, f in enumerate(flt.features) if f.ic]
    if not ic_idx:
        return []
    num_ic = len(ic_idx)
    n_hyp = max_hyp
    best_support, best_li = 0, []
    i = 0
    while i < n_hyp:
        k = 3 if num_ic > 3 else 1
        draw = rng.permutation(num_ic)[:k]
        sel = [ic_idx[j] for j in draw]
        hi = np.concatenate([flt.features[j].h for j in sel])
        zi = np.concatenate([flt.features[j].z for j in sel])
        big_h = np.concatenate([flt.features[j].H for j in sel], axis=0)
        s = big_h @ flt.p @ big_h.T + flt.std_z**2 * np.eye(2 * k)
        gain = flt.p @ big_h.T @ np.linalg.inv(s)
        xi = flt.x + gain @ (zi - hi)
        # support: vectorized reprojection of every IC feature under xi
        support, li = 0, []
        for j in ic_idx:
            resid = np.linalg.norm(
                flt.features[j].z - h_of_feature(xi, flt.features[j])
            )
            if resid < flt.std_z:
                support += 1
                li.append(j)
        if support > best_support:
            best_support, best_li = support, li
            eps_out = 1.0 - support / num_ic
            if eps_out > 0:
                n_hyp = min(
                    n_hyp,
                    math.ceil(math.log(1 - p_free) / math.log(eps_out)),
                )
            else:
                n_hyp = 0
        i += 1
    return best_li


def kalman_update_np(flt: RefFilter, idxs: list[int], on_prior=None) -> None:
    """update.m:27-56 on the stacked selected measurements."""
    if not idxs:
        return
    x0, p0 = (flt.x, flt.p) if on_prior is None else on_prior
    big_h = np.concatenate([flt.features[j].H for j in idxs], axis=0)
    nu = np.concatenate(
        [flt.features[j].z - flt.features[j].h for j in idxs]
    )
    s = big_h @ p0 @ big_h.T + flt.std_z**2 * np.eye(len(nu))
    gain = p0 @ big_h.T @ np.linalg.inv(s)
    flt.x = x0 + gain @ nu
    p = p0 - gain @ s @ gain.T
    flt.p = 0.5 * (p + p.T)
    flt.x[3:7] /= np.linalg.norm(flt.x[3:7])


def rescue_hi_inliers_np(flt: RefFilter, li: list[int]) -> list[int]:
    """rescue_hi_inliers.m:27-47: recompute h/H at the post-li state and
    χ²(2,.95)=5.9915-gate the remaining IC matches."""
    hi_list = []
    for j, feat in enumerate(flt.features):
        if not feat.ic or j in li or feat.h is None:
            continue
        h = h_of_feature(flt.x, feat)
        hrow = feature_jacobian(flt.x, feat)
        s = hrow @ flt.p @ hrow.T + flt.std_z**2 * np.eye(2)
        nu = feat.z - h
        if nu @ np.linalg.solve(s, nu) < 5.9915:
            feat.h, feat.H = h, hrow
            hi_list.append(j)
    return hi_list


def ekf_predict_np(flt: RefFilter, dx: np.ndarray, dq: np.ndarray) -> None:
    """predict_state_and_covariance.m:27-143 with the VO increment as
    control: pose composition, FD F/G Jacobians (odometry_model.m:62-68
    equivalents), hand-tuned process noise, blockwise covariance."""
    def fv(cam, u):
        r, q = cam[0:3], cam[3:7]
        rot = q2r_np(q)
        return np.concatenate([r + rot @ u[0:3], qprod_np(q, u[3:7]),
                               cam[7:13]])

    cam = flt.x[:13]
    u = np.concatenate([dx, dq])
    eps = 1e-6
    f = np.zeros((13, 13))
    g = np.zeros((13, 7))
    base = fv(cam, u)
    for c in range(13):
        cp = cam.copy()
        cp[c] += eps
        f[:, c] = (fv(cp, u) - base) / eps
    for c in range(7):
        up = u.copy()
        up[c] += eps
        g[:, c] = (fv(cam, up) - base) / eps
    pn = np.zeros((7, 7))
    pn[:3, :3] = np.eye(3) * (0.01 / 3) ** 2
    # cov_dq = Qe diag(e²) Qeᵀ with Qe = ∂q/∂e at the nominal Euler noise
    # (predict_state_and_covariance.m:98-102), Qe by finite differences
    e = 0.24 / 2 * np.pi / 180 * np.array([1.0, 0.1, 1.0])

    def e2q_np(ev):
        cr, sr = np.cos(ev[0] / 2), np.sin(ev[0] / 2)
        cp_, sp_ = np.cos(ev[1] / 2), np.sin(ev[1] / 2)
        cy_, sy_ = np.cos(ev[2] / 2), np.sin(ev[2] / 2)
        return np.array([
            cr * cp_ * cy_ + sr * sp_ * sy_,
            sr * cp_ * cy_ - cr * sp_ * sy_,
            cr * sp_ * cy_ + sr * cp_ * sy_,
            cr * cp_ * sy_ - sr * sp_ * cy_,
        ])

    qe = np.zeros((4, 3))
    for c in range(3):
        ep = e.copy()
        ep[c] += 1e-7
        qe[:, c] = (e2q_np(ep) - e2q_np(e)) / 1e-7
    pn[3:, 3:] = qe @ np.diag(e**2) @ qe.T
    q_blk = g @ pn @ g.T
    flt.x[:13] = base
    pcc = flt.p[:13, :13]
    pcl = flt.p[:13, 13:]
    flt.p[:13, :13] = f @ pcc @ f.T + q_blk
    flt.p[:13, 13:] = f @ pcl
    flt.p[13:, :13] = flt.p[:13, 13:].T
    flt.x[3:7] /= np.linalg.norm(flt.x[3:7])


def add_feature_np(flt: RefFilter, uvd: np.ndarray, xyz: np.ndarray,
                   desc: np.ndarray, step: int) -> None:
    """initialize_a_feature_sift_3.m:27-150 + add_features_inverse_depth.m:
    inverse-depth init with RGB-D depth prior ρ=1/‖xyz‖, σρ=0.01·ρ², and
    covariance augmentation by the full init Jacobian (FD here)."""
    r_wc, q_wc = flt.x[0:3], flt.x[3:7]
    rho = 1.0 / max(np.linalg.norm(xyz), 1e-6)
    uv = undistort_np(uvd)
    hx = (uv[0] - CX) / F
    hy = (uv[1] - CY) / F
    n = q2r_np(q_wc) @ np.array([hx, hy, 1.0])
    theta = math.atan2(n[0], n[2])
    phi = math.atan2(-n[1], math.hypot(n[0], n[2]))
    y = np.array([*r_wc, theta, phi, rho])

    def init_fn(pose7, uvd_, rho_):
        rr, qq = pose7[0:3], pose7[3:7] / np.linalg.norm(pose7[3:7])
        uv_ = undistort_np(uvd_)
        v = q2r_np(qq) @ np.array(
            [(uv_[0] - CX) / F, (uv_[1] - CY) / F, 1.0]
        )
        return np.array([
            *rr, math.atan2(v[0], v[2]),
            math.atan2(-v[1], math.hypot(v[0], v[2])), rho_,
        ])

    eps = 1e-5
    j_pose = np.zeros((6, 7))
    base = init_fn(flt.x[0:7], uvd, rho)
    for c in range(7):
        pp = flt.x[0:7].copy()
        pp[c] += eps
        j_pose[:, c] = (init_fn(pp, uvd, rho) - base) / eps
    j_uv = np.zeros((6, 2))
    for c in range(2):
        up = uvd.copy()
        up[c] += eps
        j_uv[:, c] = (init_fn(flt.x[0:7], up, rho) - base) / eps
    j_rho = (init_fn(flt.x[0:7], uvd, rho + eps) - base)[:, None] / eps
    d_old = len(flt.x)
    sigma_rho = 0.01 * rho * rho
    r_meas = np.diag([flt.std_z**2, flt.std_z**2, sigma_rho**2])
    j_meas = np.concatenate([j_uv, j_rho], axis=1)
    p_new = np.zeros((d_old + 6, d_old + 6))
    p_new[:d_old, :d_old] = flt.p
    cross = j_pose @ flt.p[0:7, :]
    p_new[d_old:, :d_old] = cross
    p_new[:d_old, d_old:] = cross.T
    p_new[d_old:, d_old:] = (
        j_pose @ flt.p[0:7, 0:7] @ j_pose.T + j_meas @ r_meas @ j_meas.T
    )
    flt.x = np.concatenate([flt.x, y])
    flt.p = p_new
    flt.features.append(
        RefFeature(offset=d_old, dim=6, desc=desc.copy(), init_frame=step)
    )


def map_management_np(flt: RefFilter, uv, xyz, desc, step: int,
                      min_measured: int = 50, max_adds: int = 8) -> None:
    """map_management.m:27-80: delete (ratio/age gates,
    delete_features.m:32-46), then re-initialize to keep min_measured
    (mono_slam.m:91 → 50)."""
    # delete pass (loop, with state/cov row-col removal per feature)
    for j in reversed(range(len(flt.features))):
        feat = flt.features[j]
        bad = (feat.times_predicted > 5
               and feat.times_measured < 0.5 * feat.times_predicted)
        bad |= (step - feat.init_frame > 20 and feat.times_measured < 3)
        if bad:
            o, ddim = feat.offset, feat.dim
            keep = np.r_[0:o, o + ddim:len(flt.x)]
            flt.x = flt.x[keep]
            flt.p = flt.p[np.ix_(keep, keep)]
            for f2 in flt.features:
                if f2.offset > o:
                    f2.offset -= ddim
            flt.features.pop(j)
    n_meas = sum(f.ic for f in flt.features)
    if n_meas >= min_measured or len(desc) == 0:
        return
    added = 0
    occupied = [f.h for f in flt.features if f.h is not None]
    for i in np.argsort(-np.linalg.norm(xyz, axis=1) * 0 + 1)[:len(uv)]:
        if added >= max_adds:
            break
        if not np.isfinite(xyz[i]).all() or np.linalg.norm(xyz[i]) < 0.4:
            continue
        if any(np.linalg.norm(uv[i] - h) < 10 for h in occupied):
            continue
        add_feature_np(flt, uv[i], xyz[i], desc[i], step)
        occupied.append(uv[i])
        added += 1


def run_reference_slam(frames, min_measured: int = 50, seed: int = 0,
                       verbose: bool = False):
    """The full mono_slam.m:113-435 per-frame loop on synthetic SR4000
    frames (same renderer as bench.py). frames: list of objects with
    .intensity [144,176], .xyz [144,176,3], .confidence.

    Steady-state per-frame cost with warm caches (generous to the
    reference): 1× SIFT extract per frame (the disk caches amortize the
    reference's up-to-3× SIFT reuse, SURVEY §3.3), 1× siftmatch + adaptive
    RANSAC for VO, the EKF measurement/match/RANSAC/update chain, map
    management. Returns (traj [F,3], per-frame seconds list)."""
    import time

    rng = np.random.default_rng(seed)
    flt = RefFilter(
        x=np.concatenate([np.zeros(3), [1, 0, 0, 0], np.zeros(6)]),
        p=np.diag(np.concatenate([
            np.full(7, 1e-7), np.full(6, 0.025**2)
        ])),
    )
    prev = None
    traj = []  # pose after processing each frame
    times = []
    for step, fr in enumerate(frames):
        t0 = time.perf_counter()
        img = np.asarray(fr.intensity, np.float64)
        xyz_img = np.nan_to_num(np.asarray(fr.xyz, np.float64))
        uv, desc = sift_numpy(img)
        # depth-lift (SIFT_extract_save.m:75-88 loop)
        pts = np.zeros((len(uv), 3))
        ok = np.zeros(len(uv), bool)
        for i in range(len(uv)):
            r, c = int(round(uv[i, 1])), int(round(uv[i, 0]))
            if 0 <= r < N_ROWS and 0 <= c < N_COLS:
                p = xyz_img[r, c]
                if np.isfinite(p).all() and np.linalg.norm(p) > 0.4:
                    pts[i], ok[i] = p, True
        if step == 0:
            map_management_np(flt, uv[ok], pts[ok], desc[ok], step,
                              min_measured, max_adds=32)
            prev = (uv[ok], pts[ok], desc[ok])
            traj.append(flt.x[0:3].copy())
            times.append(time.perf_counter() - t0)
            continue  # frame 0: bootstrap only (mono_slam.m first step)
        # VO: match prev↔cur + adaptive RANSAC (vodometry_dr_ye.m)
        cur = (uv[ok], pts[ok], desc[ok])
        pairs = siftmatch_numpy(prev[2], cur[2])
        if len(pairs) >= 4:
            r, t, _, _ = adaptive_ransac_vo(
                prev[1][pairs[:, 0]], cur[1][pairs[:, 1]], rng
            )
        else:
            r, t = np.eye(3), np.zeros(3)
        # quaternion of R (w,x,y,z)
        tr = np.trace(r)
        w = math.sqrt(max(1 + tr, 1e-12)) / 2
        dq = np.array([
            w, (r[2, 1] - r[1, 2]) / (4 * w),
            (r[0, 2] - r[2, 0]) / (4 * w), (r[1, 0] - r[0, 1]) / (4 * w),
        ])
        ekf_predict_np(flt, t, dq / np.linalg.norm(dq))
        predict_camera_measurements(flt)
        match_features(flt, cur[0], cur[2])
        x_prior, p_prior = flt.x.copy(), flt.p.copy()
        li = adaptive_ransac_hypotheses(flt, rng)
        kalman_update_np(flt, li, on_prior=(x_prior, p_prior))
        hi = rescue_hi_inliers_np(flt, li)
        kalman_update_np(flt, hi)
        for j in set(li) | set(hi):
            flt.features[j].times_measured += 1
        map_management_np(flt, cur[0], cur[1], cur[2], step, min_measured)
        prev = cur
        traj.append(flt.x[0:3].copy())
        times.append(time.perf_counter() - t0)
        if verbose:
            print(f"frame {step}: {times[-1]*1e3:.0f} ms, "
                  f"{len(flt.features)} features, {len(li)} li, "
                  f"{len(hi)} hi", flush=True)
    return np.asarray(traj), times
