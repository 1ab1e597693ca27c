"""Synthetic SR4000-like RGB-D sequence generator with ground truth.

The reference repo ships no SR4000 dataset, so (per SURVEY §7.2-2) all
sequence-level testing/benchmarking uses rendered scenes with known
trajectories: a world of textured 3D point-landmarks in front of a wall,
viewed by a camera following a smooth trajectory, rendered through the
exact SR4000 camera model (176×144, f=250.577, 2-param radial distortion).

Each landmark carries a fixed random texture patch so SIFT/NCC descriptors
are distinctive and trackable across frames. Per-pixel xyz is generated by
ray casting (wall) and point splatting (landmarks), so depth-lifting a
detected feature recovers the true 3D geometry — ground truth for free.

Host-side numpy: frames are tiny; device work starts downstream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from pre3_tpu_torch.data.sr4000 import Frame, H, W


class Scene(NamedTuple):
    points: np.ndarray  # [N, 3] world landmarks
    patterns: np.ndarray  # [N, P, P] per-landmark texture
    wall_z: float  # world-frame wall depth
    brightness: np.ndarray  # [N] per-landmark peak intensity
    # world-frame floor plane y_w = floor_y (y-down convention: positive
    # = below the camera start). None = wall-only scene (the default).
    # A floor makes the plane-fit orientation prior (backend/plane_fit)
    # measurable on synthetic scenes — the reference's
    # INITIAL_ORIENTATION_COMPENSATION scenario (config_file.m:29).
    floor_y: float | None = None


class Trajectory(NamedTuple):
    t: np.ndarray  # [F, 3] camera centers (world)
    r: np.ndarray  # [F, 3, 3] camera-to-world rotations


# SR4000 calibration (matches geometry.camera.sr4000_camera)
_F, _CX, _CY = 250.57731, 91.69, 72.27
_K1, _K2 = -0.84656, 0.53701
PATCH = 13


def make_scene(
    n_points: int = 400,
    seed: int = 0,
    depth_range: tuple[float, float] = (1.2, 3.5),
    lateral: float = 1.8,
    wall_z: float = 4.0,
    x_range: tuple[float, float] | None = None,
) -> Scene:
    """x_range: override the lateral x extent (corridor scenes for long
    drifting trajectories — keep per-view density by scaling n_points with
    the corridor length)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(*depth_range, n_points)
    if x_range is None:
        x_range = (-lateral, lateral)
    x = rng.uniform(*x_range, n_points)
    y = rng.uniform(-lateral * 0.8, lateral * 0.8, n_points)
    points = np.stack([x, y, z], axis=-1).astype(np.float32)
    # Texture: lightly-smoothed random speckle under a Gaussian envelope.
    # Blob-like enough that DoG extrema land at interior pyramid scales
    # (single-pixel spikes would concentrate at the excluded finest level),
    # with enough speckle to disambiguate descriptors; FAST fires on the
    # bright-blob-vs-ring contrast.
    patterns = rng.uniform(0.35, 1.0, (n_points, PATCH, PATCH)).astype(np.float32)
    # 3×3 binomial smoothing of the speckle
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    pad = np.pad(patterns, ((0, 0), (1, 1), (1, 1)), mode="edge")
    patterns = (
        k[0] * pad[:, :-2, 1:-1] + k[1] * pad[:, 1:-1, 1:-1] + k[2] * pad[:, 2:, 1:-1]
    )
    pad = np.pad(patterns, ((0, 0), (0, 0), (1, 1)), mode="edge")
    patterns = k[0] * pad[:, :, :-2] + k[1] * pad[:, :, 1:-1] + k[2] * pad[:, :, 2:]
    yy, xx = np.mgrid[0:PATCH, 0:PATCH] - PATCH // 2
    gauss = np.exp(-(xx**2 + yy**2) / (2 * 2.6**2)).astype(np.float32)
    patterns = 0.25 + 0.75 * patterns * gauss[None]
    patterns *= gauss[None] > 0.05
    brightness = rng.uniform(0.6, 1.0, n_points).astype(np.float32)
    return Scene(points=points, patterns=patterns, wall_z=wall_z,
                 brightness=brightness)


def make_trajectory(
    n_frames: int,
    seed: int = 1,
    step_t: float = 0.03,
    step_r_deg: float = 1.0,
    loop: bool | int = False,
) -> Trajectory:
    """Smooth handheld-like motion: small per-frame translation + rotation,
    low-pass filtered so consecutive VO deltas are realistic (~3 cm, ~1°).

    loop=True reverses the drift bias halfway (out-and-back without
    turning): the camera revisits the outbound viewpoints facing the same
    way, so a persistent map can re-acquire its landmarks — the loop-
    closure benchmark scenario. An integer loop=N makes N out-and-back
    passes (2N legs over the same half-corridor → ≥ 2N−1 revisits of the
    outbound viewpoints — the multi-loop scenario of VERDICT r4 #3)."""
    rng = np.random.default_rng(seed)
    dt = rng.normal(scale=step_t, size=(n_frames, 3))
    dr = rng.normal(scale=np.radians(step_r_deg), size=(n_frames, 3))
    # Low-pass (moving average) for smoothness; bias toward +x drift so the
    # trajectory actually goes somewhere.
    k = min(5, n_frames)
    kernel = np.ones(k) / k
    for a in (dt, dr):
        for c in range(3):
            a[:, c] = np.convolve(a[:, c], kernel, mode="same")
    if loop:
        n_legs = 2 * max(1, int(loop))
        leg = n_frames // n_legs
        for li in range(n_legs):
            lo = li * leg
            hi = (li + 1) * leg if li < n_legs - 1 else n_frames
            dt[lo:hi, 0] += step_t * 0.5 * (1.0 if li % 2 == 0 else -1.0)
    else:
        dt[:, 0] += step_t * 0.5
    ts = np.cumsum(dt, axis=0)
    ts -= ts[0]
    rs = np.zeros((n_frames, 3, 3))
    r = np.eye(3)
    for i in range(n_frames):
        r = r @ _rodrigues(dr[i])
        rs[i] = r
    return Trajectory(t=ts.astype(np.float32), r=rs.astype(np.float32))


def _rodrigues(v: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    k = v / angle
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def _distort_px(u: np.ndarray, v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    xu = (u - _CX) / _F
    yu = (v - _CY) / _F
    r2 = xu * xu + yu * yu
    d = 1 + _K1 * r2 + _K2 * r2 * r2
    return _CX + _F * xu * d, _CY + _F * yu * d


def _undistort_grid() -> np.ndarray:
    """Per-pixel unit-z camera rays for the distorted pixel grid (Newton
    inversion of the radial model), cached at module level."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    xd = (u - _CX) / _F
    yd = (v - _CY) / _F
    rd = np.sqrt(xd * xd + yd * yd)
    ru = rd / (1 + _K1 * rd**2 + _K2 * rd**4)
    for _ in range(10):
        f1 = ru + _K1 * ru**3 + _K2 * ru**5 - rd
        f1p = 1 + 3 * _K1 * ru**2 + 5 * _K2 * ru**4
        ru = ru - f1 / f1p
    d = 1 + _K1 * ru**2 + _K2 * ru**4
    return np.stack([xd / d, yd / d, np.ones_like(xd)], axis=-1)


_RAYS = _undistort_grid()


def render_frame(
    scene: Scene, t_wc: np.ndarray, r_wc: np.ndarray, timestamp: float,
    noise: float = 0.01, seed: int = 0,
) -> Frame:
    """Render one frame: intensity (textured landmark splats over a dark
    wall), per-pixel xyz (ray-cast wall + landmark depth), confidence."""
    rng = np.random.default_rng(seed)
    r_cw = r_wc.T
    p_cam = (scene.points - t_wc) @ r_cw.T  # [N, 3]

    # Background: ray-cast the wall plane z_w = wall_z.
    # ray in world: d_w = R_wc @ ray_cam ; t + s·d_w hits z_w = wall_z.
    d_w = _RAYS @ r_wc.T  # [H, W, 3]
    denom = d_w[..., 2]
    s = (scene.wall_z - t_wc[2]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    hit = s > 0.2
    wall_cam_z = s  # camera-frame z of wall along unit-z rays
    if scene.floor_y is not None:
        # floor plane y_w = floor_y: take the nearer of wall/floor hits
        denf = d_w[..., 1]
        sf = (scene.floor_y - t_wc[1]) / np.where(
            np.abs(denf) < 1e-9, 1e-9, denf
        )
        hitf = sf > 0.2
        nearer_floor = hitf & (~hit | (sf < wall_cam_z))
        wall_cam_z = np.where(nearer_floor, sf, wall_cam_z)
        hit = hit | hitf
    xyz = _RAYS * np.where(hit, wall_cam_z, np.nan)[..., None]
    intensity = np.full((H, W), 0.08, np.float32)
    if scene.floor_y is not None:
        # mild texture on the floor so it's a real (if feature-poor)
        # surface in the intensity image too
        intensity = np.where(
            nearer_floor, (0.12 + 0.02 * ((np.arange(W)[None, :]
                                           + np.arange(H)[:, None]) % 3)
                           ).astype(np.float32),
            intensity,
        )
    confidence = np.where(hit, 0.9, 0.05).astype(np.float32)

    # Landmark splats, far-to-near.
    z = p_cam[:, 2]
    vis = z > 0.3
    u, v = _distort_px(
        _CX + _F * p_cam[:, 0] / np.where(vis, z, 1.0),
        _CY + _F * p_cam[:, 1] / np.where(vis, z, 1.0),
    )
    half = PATCH // 2
    vis &= (u > half + 1) & (u < W - half - 2) & (v > half + 1) & (v < H - half - 2)
    order = np.argsort(-z)
    for i in order:
        if not vis[i]:
            continue
        cu, cv = int(round(u[i])), int(round(v[i]))
        pat = scene.patterns[i] * scene.brightness[i]
        ys, xs = slice(cv - half, cv + half + 1), slice(cu - half, cu + half + 1)
        # occlusion: only draw where nearer than current depth buffer
        cur_z = xyz[ys, xs, 2]
        nearer = ~(cur_z < z[i])  # NaN-safe: draw over NaN background
        intensity[ys, xs] = np.where(
            nearer, np.maximum(intensity[ys, xs], pat), intensity[ys, xs]
        )
        # per-pixel xyz on the splat: local rays scaled to the landmark depth
        splat_xyz = _RAYS[ys, xs] * z[i]
        xyz[ys, xs] = np.where(nearer[..., None], splat_xyz, xyz[ys, xs])
        confidence[ys, xs] = np.where(nearer, 1.0, confidence[ys, xs])

    if noise > 0:
        intensity = intensity + rng.normal(scale=noise, size=(H, W)).astype(
            np.float32
        )
    intensity = np.clip(intensity, 0.0, 1.0).astype(np.float32)
    return Frame(
        intensity=intensity,
        xyz=xyz.astype(np.float32),
        confidence=confidence,
        timestamp=timestamp,
    )


def render_sequence(
    n_frames: int = 30,
    scene_seed: int = 0,
    traj_seed: int = 1,
    n_points: int = 400,
    noise: float = 0.01,
    dt: float = 0.1,
    step_t: float = 0.03,
    step_r_deg: float = 1.0,
    x_range: tuple[float, float] | None = None,
    loop: bool | int = False,
    floor_y: float | None = None,
    tilt_deg: float = 0.0,
) -> tuple[list[Frame], Trajectory, Scene]:
    """Render a full sequence; returns frames + ground-truth trajectory.

    For long sequences the trajectory drifts ≈ step_t/2 per frame in +x;
    pass x_range ≈ (−lateral, drift·n_frames + lateral) with n_points
    scaled by corridor length so the camera always sees a populated scene.

    floor_y adds a world floor plane (see Scene.floor_y); tilt_deg
    pitches the WHOLE camera trajectory about x (camera pitched down
    toward the floor) while the world stays gravity-aligned — the
    tilted-start scenario where the plane-fit orientation prior
    (SlamConfig.initial_orientation) matters.
    """
    scene = make_scene(n_points=n_points, seed=scene_seed, x_range=x_range)
    if floor_y is not None:
        scene = scene._replace(floor_y=floor_y)
    traj = make_trajectory(
        n_frames, seed=traj_seed, step_t=step_t, step_r_deg=step_r_deg,
        loop=loop,
    )
    if tilt_deg:
        r_tilt = _rodrigues(np.array([np.radians(tilt_deg), 0.0, 0.0]))
        traj = traj._replace(
            r=np.einsum("fij,jk->fik", traj.r, r_tilt).astype(np.float32)
        )
    frames = [
        render_frame(scene, traj.t[i], traj.r[i], timestamp=i * dt,
                     noise=noise, seed=1000 + i)
        for i in range(n_frames)
    ]
    return frames, traj, scene
