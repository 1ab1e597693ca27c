"""The full EKF-SLAM step and the loop that runs it over a sequence.

Port of ``pre3_tpu/ekf/slam.py``. Per frame k:
  1. EKF prediction with the VO increment as control (vo_pair: K2 match,
     K1-scored RANSAC, IFT covariance as process noise)
  2. measurement prediction + IC matching of the map (K2)
  3. 1-point RANSAC li-inlier selection, li update applied to the prior
  4. hi-inlier rescue at the post-li state, hi update on the posterior
  5. bookkeeping counters
  6. map management: delete / convert / add

Matchers: descriptors (``search_ic_matches``, K2) or, with
``matcher="ncc_warp"`` and per-frame intensity images, the warped-patch
NCC scan (``ncc_matching.py``). Estimation methods: 1PRE (above),
``pure_ekf`` (one update on every IC match) and ``iekf`` (iterated update
on every IC match); an optional periodic gravity-direction update from a
floor-plane fit closes the step.

``run_slam_batched`` runs S independent sequences at once: each step is
one ``torch.func.vmap`` of ``slam_step`` over the sequences, so K1 and K2
launch once per step for all of them (their custom ops' vmap rules), as
the reference's tools/measure_batch.py vmaps its ``run_slam``.

The reference's ``lax.scan`` is a Python loop that never reads a value
back to the host. Its ``lax.cond`` on VO success is a ``torch.where``
over both branches; its ``lax.cond`` on the step number (the periodic
attitude update) is decided from the loop's host-side index, so the
512-hypothesis plane fit runs on 1 step in N only. JAX's threefry draws
cannot be reproduced in torch, so every random draw is an input
(``draws=``) or comes from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.func import jacfwd

from pre3_tpu_torch.backend.plane_fit import (
    floor_up_direction, initial_orientation_from_floor,
)
from pre3_tpu_torch.ekf.map_management import (
    add_features, convert_to_cartesian, delete_features,
)
from pre3_tpu_torch.ekf.measurement import (
    predict_measurements, search_ic_matches,
)
from pre3_tpu_torch.ekf.ncc_matching import search_ic_matches_ncc
from pre3_tpu_torch.ekf.one_point_ransac import (
    one_point_ransac, pool_size, rescue_hi_inliers,
)
from pre3_tpu_torch.ekf.prediction import _PN, predict, predict_cv
from pre3_tpu_torch.ekf.state import CAM_DIM, EkfState, init_state
from pre3_tpu_torch.ekf.update import (
    attitude_update, iterated_kalman_update, kalman_update,
)
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.quaternion import q2v, qrotate, v2q
from pre3_tpu_torch.utils.device import to_device
from pre3_tpu_torch.vo.dead_reckoning import vo_pair
from pre3_tpu_torch.vo.ransac import _draw_gumbel


class SlamConfig(NamedTuple):
    """The reference's SlamConfig, field for field (see
    pre3_tpu/ekf/slam.py for what each option does and why)."""

    std_z: float = 1.0  # px measurement noise
    ransac_batch: int = 256  # 1-pt RANSAC hypotheses
    ransac_points: int = 3  # matches per hypothesis (3PRE mode; 1 = classic)
    vo_batch: int = 512  # VO RANSAC hypotheses
    match_ratio: float = 1.5  # Lowe ratio (siftmatch.c default)
    max_adds: int = 8
    min_measured: int = 25  # re-init support target
    est_method: str = "1pre"  # "1pre" | "pure_ekf" | "iekf"
    matcher: str = "desc"  # "desc" | "ncc_warp" (needs per-frame images)
    ncc_threshold: float = 0.60
    only_predict: bool = False  # dead-reckon, no update
    init_sampling: str = "topk"  # "topk" | "weighted"
    max_age: int = 10_000  # landmark lifetime in frames
    max_invisible: int = 20  # frames out of view before deletion
    vo_noise_from_covariance: bool = True  # IFT VO covariance as noise
    vo_range_weighted: bool = True  # 1/range² weights in the VO refit
    initial_orientation: bool = True  # plane-fit q0 from frame 0's xyz
    heading_update_every: int = 0  # every N steps, attitude update from a
    # floor-plane fit (needs per-frame xyz images); 0 = off
    motion_model: str = "odometry"  # "odometry" | "odo_cv_fallback" | "cv"
    dt: float = 0.1  # sensor period
    std_a: float = 0.1  # linear acceleration noise
    std_alpha: float = 0.1  # angular acceleration noise
    depth_range_quadratic: bool = True  # σ_d ∝ range² beyond d0
    depth_range_d0: float = 1.5  # knee of the hybrid prior, meters
    match_gate_first: bool = False  # gate before the ratio test
    max_update_slots: int = 0  # bound each update to this many slots


class StepStats(NamedTuple):
    """Per-step observability record."""

    n_visible: torch.Tensor
    n_ic: torch.Tensor
    n_li: torch.Tensor
    n_hi: torch.Tensor
    n_active: torch.Tensor
    vo_ok: torch.Tensor
    vo_inliers: torch.Tensor
    # inlier slots dropped because more than max_update_slots measured
    update_overflow: torch.Tensor | int = 0


class StepRecord(NamedTuple):
    """Per-step inlier observations recorded for the BA backend."""

    z: torch.Tensor  # [K, 2]
    z_xyz: torch.Tensor  # [K, 3]
    measured: torch.Tensor  # [K] bool — li | hi inlier this step
    init_frame: torch.Tensor  # [K] int32
    visible: torch.Tensor  # [K] bool — predicted in image this step


class StepDraws(NamedTuple):
    """One step's random draws (standard Gumbel noise); a None field is
    drawn from the generator instead. Stacked for a sequence, the first
    three fields have a leading step axis and ``heading`` one entry per
    step that runs the plane fit, in order."""

    vo: torch.Tensor | None = None  # [vo_batch, Kf] VO RANSAC sampling
    ransac: torch.Tensor | None = None  # [ransac_batch, M] 1-PRE sampling
    add: torch.Tensor | None = None  # [Kf] add sampling ("weighted" only)
    heading: torch.Tensor | None = None  # [512, N_region] floor-plane
    # RANSAC of the periodic attitude update (its steps only)


class SlamDraws(NamedTuple):
    """A sequence's random draws: ``steps`` fields with leading axis F−1,
    plus the bootstrap's."""

    steps: StepDraws
    boot_add: torch.Tensor | None = None  # [Kf] ("weighted" only)
    plane: torch.Tensor | None = None  # [512, N_region] floor-plane RANSAC


class SlamTrajectory(NamedTuple):
    t: torch.Tensor  # [F, 3]
    q: torch.Tensor  # [F, 4]
    stats: StepStats  # fields have leading axis F-1
    records: StepRecord  # fields have leading axis F-1


def draw_step(
    cfg: SlamConfig,
    n_feats: int,
    n_landmarks: int,
    generator: torch.Generator | None,
    device: torch.device | str,
    draws: StepDraws | None = None,
) -> StepDraws:
    """One step's draws: the fields ``draws`` sets, and every other draw
    the step consumes under ``cfg`` taken from ``generator`` in the order
    slam_step consumes them: VO RANSAC [vo_batch, n_feats], 1-PRE
    [ransac_batch, pool] and add sampling [n_feats] ("weighted" only).
    The attitude update's plane fit, the step's last draw, stays with
    ``floor_up_direction``. Without a generator the missing fields stay
    None."""
    d = StepDraws() if draws is None else draws
    if generator is None:
        return d

    def take(field, needed, shape):
        if field is not None or not needed:
            return field
        return _draw_gumbel(shape, generator, device=device)

    ms = cfg.max_update_slots if cfg.max_update_slots > 0 else None
    return StepDraws(
        vo=take(d.vo, cfg.motion_model != "cv", (cfg.vo_batch, n_feats)),
        ransac=take(d.ransac, cfg.est_method not in ("pure_ekf", "iekf")
                    and not cfg.only_predict,
                    (cfg.ransac_batch, pool_size(n_landmarks, ms))),
        add=take(d.add, cfg.init_sampling == "weighted", (n_feats,)),
        heading=d.heading,
    )


def _where_state(cond: torch.Tensor, a: EkfState, b: EkfState) -> EkfState:
    """Field-wise ``torch.where`` of two states (both branches computed)."""
    return EkfState(*(torch.where(cond, u, v) for u, v in zip(a, b)))


def slam_step(
    cam_model: Camera,
    state: EkfState,
    frame: Features,
    prev_frame: Features,
    step: torch.Tensor,  # [] int32
    cfg: SlamConfig = SlamConfig(),
    draws: StepDraws | None = None,
    generator: torch.Generator | None = None,
    image: torch.Tensor | None = None,  # [H, W] — needed by ncc_warp
    xyz_img: torch.Tensor | None = None,  # [H, W, 3]
    host_step: int | None = None,
) -> tuple[EkfState, tuple[StepStats, StepRecord]]:
    """One EKF-SLAM step. ``draws`` supplies the step's Gumbel noise;
    fields it leaves None are drawn from ``generator``: the RANSACs' and
    the add sampling's before anything else runs (``draw_step``), the
    plane fit's where it runs. With
    cfg.heading_update_every = N > 0 the step needs its xyz image and
    ``host_step``, its index as a host integer (``step`` lives on the
    device): where host_step % N == 0 the floor plane is fitted and the
    attitude update applied. With cfg.matcher="ncc_warp" the map is
    matched by the warped-patch NCC scan of ``image``, and new features
    record their init patches from it."""
    if cfg.matcher == "ncc_warp" and image is None:
        raise ValueError("matcher='ncc_warp' needs the intensity image")
    if cfg.heading_update_every > 0 and (xyz_img is None or host_step is None):
        raise ValueError("heading_update_every > 0 needs per-frame xyz "
                         "images and the step's host index (host_step)")
    dev, dt = state.x.device, state.x.dtype
    draws = draw_step(cfg, frame.uv.shape[0], state.n_landmarks, generator,
                      dev, draws)

    # 1. VO control input + prediction, with the estimated VO covariance
    # (mapped [dt, dω] → [dX, dq]) plus the reference's floor as noise
    if cfg.motion_model == "cv":
        state = predict_cv(state, dt=cfg.dt, std_a=cfg.std_a,
                           std_alpha=cfg.std_alpha)
        vo_ok = torch.zeros((), dtype=torch.bool, device=dev)
        vo_inliers = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        vo = vo_pair(
            prev_frame, frame, gumbel=draws.vo,
            batch=cfg.vo_batch, with_covariance=cfg.vo_noise_from_covariance,
            range_weighted_refit=cfg.vo_range_weighted,
        )
        unit7 = torch.zeros(7, dtype=dt, device=dev)
        unit7[3].fill_(1.0)
        u = torch.where(vo.ok, torch.cat([vo.delta.t, vo.delta.q]), unit7)
        q_pre = state.x[3:7]  # orientation BEFORE prediction
        if cfg.vo_noise_from_covariance:
            jq = jacfwd(v2q)(q2v(vo.delta.q))  # [4, 3] ∂q/∂ω at the fit
            # blockdiag(I₃, jq), built out of place so that vmap can
            # batch jq
            j = torch.cat([
                torch.eye(3, 6, dtype=dt, device=dev),
                torch.cat([torch.zeros((4, 3), dtype=dt, device=dev), jq], 1),
            ])
            pn = j @ vo.cov @ j.T + to_device(_PN, dev)
            # failed VO: large-ish identity-motion uncertainty
            pn = torch.where(vo.ok, pn,
                             torch.eye(7, dtype=dt, device=dev) * 1e-3)
        else:
            pn = None
        odo = predict(state, u, pn)
        if cfg.motion_model == "odo_cv_fallback":
            # VO denied → coast on the carried velocities
            state = _where_state(vo.ok, odo, predict_cv(
                state, dt=cfg.dt, std_a=cfg.std_a, std_alpha=cfg.std_alpha))
        else:
            state = odo
        # refresh the carried v/ω states from the VO velocity on success
        v_vo = qrotate(q_pre, vo.delta.t) / cfg.dt
        w_vo = q2v(vo.delta.q) / cfg.dt
        x = state.x
        x = torch.cat([x[:7], torch.where(vo.ok, v_vo, x[7:10]),
                       torch.where(vo.ok, w_vo, x[10:13]), x[CAM_DIM:]])
        state = state._replace(x=x)
        vo_ok = vo.ok
        vo_inliers = vo.n_inliers

    # 2. measurement prediction + matching of the map: descriptors, or
    # the warped-patch correlation scan
    obs = predict_measurements(cam_model, state, std_z=cfg.std_z)
    if cfg.matcher == "ncc_warp":
        # raw xyz has NaN background pixels: sanitize before sampling
        obs = search_ic_matches_ncc(
            cam_model, obs, state, image,
            xyz_img=None if xyz_img is None else torch.nan_to_num(xyz_img),
            ncc_threshold=cfg.ncc_threshold)
    else:
        obs, state = search_ic_matches(obs, state, frame,
                                       ratio=cfg.match_ratio,
                                       gate_first=cfg.match_gate_first)

    # 3./4. estimation method
    ms = cfg.max_update_slots if cfg.max_update_slots > 0 else None
    none = torch.zeros_like(obs.ic)
    obs2 = obs
    if cfg.only_predict:
        li, hi = none, none
    elif cfg.est_method == "pure_ekf":
        # one update on every IC match, no RANSAC gating
        li, hi = obs.ic, none
        state = kalman_update(state, obs, li, std_z=cfg.std_z, max_slots=ms)
    elif cfg.est_method == "iekf":
        # iterated EKF on every IC match, relinearized at each iterate
        li, hi = obs.ic, none
        state = iterated_kalman_update(cam_model, state, obs.z, li,
                                       std_z=cfg.std_z)
    else:
        # 1PRE: li update on the prior, then hi rescue on the posterior
        li = one_point_ransac(
            cam_model, state, obs, batch=cfg.ransac_batch, std_z=cfg.std_z,
            n_points=cfg.ransac_points, max_slots=ms, gumbel=draws.ransac,
        )
        state = kalman_update(state, obs, li, std_z=cfg.std_z, max_slots=ms)
        hi, obs2 = rescue_hi_inliers(cam_model, state, obs, li,
                                     std_z=cfg.std_z)
        state = kalman_update(state, obs2, hi, std_z=cfg.std_z, max_slots=ms)

    # 5. bookkeeping
    measured = li | hi
    state = state._replace(
        times_predicted=state.times_predicted + obs.visible.to(torch.int32),
        times_measured=state.times_measured + measured.to(torch.int32),
        last_visible=torch.where(obs.ic, step, state.last_visible),
    )

    # 6. map management on the posterior; the new-feature separation gate
    # reuses the last measurement prediction
    state = delete_features(state, step, max_age=cfg.max_age,
                            max_invisible=cfg.max_invisible)
    state = convert_to_cartesian(state)
    gate_h = obs2.h if (cfg.est_method == "1pre"
                        and not cfg.only_predict) else obs.h
    state = add_features(
        cam_model, state, frame, gate_h, step,
        n_measured=torch.sum(measured), max_adds=cfg.max_adds,
        min_measured=cfg.min_measured, std_pxl=cfg.std_z,
        depth_range_quadratic=cfg.depth_range_quadratic,
        depth_range_d0=cfg.depth_range_d0, image=image,
        sampling=cfg.init_sampling, gumbel=draws.add,
    )

    # periodic gravity-direction correction from a floor-plane fit, on the
    # steps the host index selects
    if cfg.heading_update_every > 0 and (
        host_step % cfg.heading_update_every == 0
    ):
        fit = floor_up_direction(torch.nan_to_num(xyz_img),
                                 gumbel=draws.heading, generator=generator)
        state = attitude_update(state, fit.normal, ok=fit.ok)

    n_li = torch.sum(li, dtype=torch.int32)
    n_hi = torch.sum(hi, dtype=torch.int32)
    if ms is not None:
        # what the bounded li and hi updates would have dropped
        overflow = (torch.clamp(n_li - ms, min=0)
                    + torch.clamp(n_hi - ms, min=0))
    else:
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    stats = StepStats(
        n_visible=torch.sum(obs.visible, dtype=torch.int32),
        n_ic=torch.sum(obs.ic, dtype=torch.int32),
        n_li=n_li, n_hi=n_hi,
        n_active=torch.sum(state.active, dtype=torch.int32),
        vo_ok=vo_ok, vo_inliers=vo_inliers, update_overflow=overflow,
    )
    record = StepRecord(z=obs.z, z_xyz=obs.z_xyz, measured=measured,
                        init_frame=state.init_frame, visible=obs.visible)
    return state, (stats, record)


def bootstrap_state(
    cam_model: Camera,
    first: Features,  # single frame
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    xyz_img: torch.Tensor | None = None,  # [H, W, 3] frame 0
    image: torch.Tensor | None = None,  # [H, W] frame 0 (init patches)
    plane_gumbel: torch.Tensor | None = None,
    add_gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> EkfState:
    """Initialize the filter and seed the map from frame 0. With
    cfg.initial_orientation and a frame-0 xyz image, x₀'s orientation is
    the gravity-aligned plane-fit prior (identity when the fit fails)."""
    q0 = None
    if cfg.initial_orientation and xyz_img is not None:
        q0, _ok = initial_orientation_from_floor(
            torch.nan_to_num(xyz_img), gumbel=plane_gumbel,
            generator=generator)
    dev = first.desc.device
    state0 = init_state(n_landmarks=n_landmarks, desc_dim=first.desc.shape[-1],
                        q0=q0, dtype=first.desc.dtype, device=dev)
    obs0 = predict_measurements(cam_model, state0, std_z=cfg.std_z)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return add_features(
        cam_model, state0, first, obs0.h, zero, n_measured=zero,
        max_adds=cfg.max_adds * 4, min_measured=cfg.min_measured,
        std_pxl=cfg.std_z, depth_range_quadratic=cfg.depth_range_quadratic,
        depth_range_d0=cfg.depth_range_d0, image=image,
        sampling=cfg.init_sampling, gumbel=add_gumbel, generator=generator,
    )


def _frame(feats: Features, i: int) -> Features:
    return Features(*(x[i] for x in feats))


def scan_steps(
    cam_model: Camera,
    state: EkfState,
    prev_last: Features,  # the frame PRECEDING this chunk (VO anchor)
    feats: Features,  # stacked chunk, leading axis C
    steps: torch.Tensor,  # [C] int32 global step indices
    cfg: SlamConfig = SlamConfig(),
    draws: StepDraws | None = None,  # stacked, see StepDraws
    generator: torch.Generator | None = None,
    xyz_imgs: torch.Tensor | None = None,  # [C, H, W, 3]
    first_step: int | None = None,  # host index of steps[0]
    images: torch.Tensor | None = None,  # [C, H, W], matcher='ncc_warp'
):
    """Run slam_step over a feature chunk; resumable (returns the carry).
    Returns (state, (t [C, 3], q [C, 4], stats, records))."""
    ts, qs, stats, records = [], [], [], []
    prev = prev_last
    n_fits = 0  # draws.heading entries used so far
    for i in range(feats.uv.shape[0]):
        cur = _frame(feats, i)
        host = None if first_step is None else first_step + i
        fits = host is not None and cfg.heading_update_every > 0 and (
            host % cfg.heading_update_every == 0)
        step_draws = None
        if draws is not None:
            pick = lambda d: None if d is None else d[i]  # noqa: E731
            step_draws = StepDraws(
                vo=pick(draws.vo), ransac=pick(draws.ransac),
                add=pick(draws.add),
                heading=(draws.heading[n_fits] if fits
                         and draws.heading is not None else None))
        n_fits += fits
        state, (st, rec) = slam_step(
            cam_model, state, cur, prev, steps[i], cfg, draws=step_draws,
            generator=generator,
            image=None if images is None else images[i],
            xyz_img=None if xyz_imgs is None else xyz_imgs[i],
            host_step=host)
        ts.append(state.x[0:3])
        qs.append(state.x[3:7])
        stats.append(st)
        records.append(rec)
        prev = cur
    stack = lambda rows, cls: cls(*(torch.stack(f) for f in zip(*rows)))
    return state, (torch.stack(ts), torch.stack(qs), stack(stats, StepStats),
                   stack(records, StepRecord))


def run_slam(
    cam_model: Camera,
    feats: Features,  # stacked, leading axis F
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    draws: SlamDraws | None = None,
    generator: torch.Generator | None = None,
    images: torch.Tensor | None = None,  # [F, H, W], matcher='ncc_warp'
    xyz_imgs: torch.Tensor | None = None,  # [F, H, W, 3]
) -> SlamTrajectory:
    """Run EKF-SLAM over a stacked feature sequence. ``draws`` supplies
    the random draws; whatever it leaves None comes from ``generator``."""
    n_frames = feats.uv.shape[0]
    dev = feats.uv.device
    draws = SlamDraws(steps=StepDraws()) if draws is None else draws
    first = _frame(feats, 0)
    state0 = bootstrap_state(
        cam_model, first, cfg, n_landmarks,
        xyz_img=None if xyz_imgs is None else xyz_imgs[0],
        image=None if images is None else images[0],
        plane_gumbel=draws.plane, add_gumbel=draws.boot_add,
        generator=generator,
    )
    steps = torch.arange(1, n_frames, dtype=torch.int32, device=dev)
    rest = Features(*(x[1:] for x in feats))
    _, (ts, qs, stats, records) = scan_steps(
        cam_model, state0, first, rest, steps, cfg, draws=draws.steps,
        generator=generator,
        xyz_imgs=None if xyz_imgs is None else xyz_imgs[1:], first_step=1,
        images=None if images is None else images[1:],
    )
    return SlamTrajectory(
        t=torch.cat([torch.zeros((1, 3), dtype=ts.dtype, device=dev), ts]),
        q=torch.cat([state0.x[3:7][None], qs]),  # identity, or the prior
        stats=stats, records=records,
    )


@contextlib.contextmanager
def no_vmap_fallback():
    """Turn off vmap's per-sample fallback: inside, an op without a
    batching rule raises instead of looping over the batch."""
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)


def _stack(rows, cls, dim: int = 0):
    return cls(*(torch.stack(f, dim) for f in zip(*rows)))


def _check_batched(cfg: SlamConfig) -> None:
    if cfg.matcher != "desc" or cfg.heading_update_every > 0:
        raise ValueError("run_slam_batched runs the descriptor matcher "
                         "without the periodic attitude update")


def bootstrap_batched(
    cam_model: Camera,
    first: Features,  # frame 0 of each sequence, leading axis S
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    boot_add: torch.Tensor | None = None,  # [S, Kf] ("weighted" only)
    generators: list[torch.Generator] | None = None,
) -> EkfState:
    """``bootstrap_state`` of each sequence, stacked on a leading S axis
    (no plane-fit prior: the batched path takes no xyz images)."""
    _check_batched(cfg)
    n_seq = first.uv.shape[0]
    return _stack([bootstrap_state(
        cam_model, Features(*(x[s] for x in first)), cfg, n_landmarks,
        add_gumbel=None if boot_add is None else boot_add[s],
        generator=None if generators is None else generators[s])
        for s in range(n_seq)], EkfState)


def draw_batched(
    cfg: SlamConfig,
    n_feats: int,
    n_landmarks: int,
    generators: list[torch.Generator] | None,
    device: torch.device | str,
    draws: StepDraws | None = None,  # fields with a leading S axis
) -> StepDraws:
    """One batched step's draws: ``draws``' fields, and every other draw
    taken from ``generators[s]`` by ``draw_step`` (outside any vmap),
    stacked on a leading S axis."""
    d = StepDraws() if draws is None else draws
    if generators is None:
        return d
    rows = [draw_step(cfg, n_feats, n_landmarks, g, device, StepDraws(*(
        None if f is None else f[s] for f in d)))
        for s, g in enumerate(generators)]
    return StepDraws(*(None if f[0] is None else torch.stack(f)
                       for f in zip(*rows)))


def slam_step_batched(
    cam_model: Camera,
    state: EkfState,  # leading axis S
    frame: Features,  # leading axis S
    prev_frame: Features,  # leading axis S
    step: torch.Tensor,  # [] int32, shared
    cfg: SlamConfig = SlamConfig(),
    draws: StepDraws | None = None,  # fields with a leading S axis
) -> tuple[EkfState, tuple[StepStats, StepRecord]]:
    """``slam_step`` of S sequences as one ``torch.func.vmap`` with vmap's
    per-sample fallback off (an op without a batching rule raises); K1
    and K2 launch once for all S. Every draw the step consumes must be in
    ``draws`` (``draw_batched``)."""
    _check_batched(cfg)
    d = StepDraws() if draws is None else draws
    dims = StepDraws(*(None if f is None else 0 for f in d))

    def one(st, cur, prev, dd, stp):
        return slam_step(cam_model, st, cur, prev, stp, cfg, draws=dd)

    with no_vmap_fallback():
        return torch.func.vmap(one, in_dims=(0, 0, 0, dims, None))(
            state, frame, prev_frame, d, step)


def run_slam_batched(
    cam_model: Camera,
    feats: Features,  # stacked, leading axes [S, F]
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    draws: SlamDraws | None = None,
    generators: list[torch.Generator] | None = None,
) -> SlamTrajectory:
    """Run EKF-SLAM over S independent sequences at once (the reference's
    ``jax.vmap(run_slam)`` in tools/measure_batch.py):
    ``bootstrap_batched``, then each of the F−1 steps as one
    ``slam_step_batched``, so K1 and K2 launch once per step for all S.

    ``draws``: a SlamDraws whose fields carry a leading S axis; whatever
    it leaves None comes from ``generators[s]``, one per sequence, drawn
    outside the vmap (``draw_batched``) in the order a single run_slam
    draws it, so sequence s matches ``run_slam(..., generator=
    generators[s])``. Returns a SlamTrajectory whose fields have a
    leading S axis. The descriptor matcher only, without the periodic
    attitude update (no per-frame images)."""
    _check_batched(cfg)
    n_seq, n_frames, n_feats = feats.uv.shape[:3]
    if generators is not None and len(generators) != n_seq:
        raise ValueError(f"run_slam_batched: {len(generators)} generators "
                         f"for {n_seq} sequences")
    draws = SlamDraws(steps=StepDraws()) if draws is None else draws
    dev = feats.uv.device
    state = bootstrap_batched(cam_model, Features(*(x[:, 0] for x in feats)),
                              cfg, n_landmarks, draws.boot_add, generators)
    q0 = state.x[:, 3:7]
    steps = torch.arange(1, n_frames, dtype=torch.int32, device=dev)
    ts, qs, stats, records = [], [], [], []
    for i in range(1, n_frames):
        d = draw_batched(cfg, n_feats, n_landmarks, generators, dev,
                         StepDraws(*(None if f is None else f[:, i - 1]
                                     for f in draws.steps)))
        state, (st, rec) = slam_step_batched(
            cam_model, state, Features(*(x[:, i] for x in feats)),
            Features(*(x[:, i - 1] for x in feats)), steps[i - 1], cfg, d)
        ts.append(state.x[:, 0:3])
        qs.append(state.x[:, 3:7])
        stats.append(st)
        records.append(rec)
    ts, qs = torch.stack(ts, 1), torch.stack(qs, 1)
    return SlamTrajectory(
        t=torch.cat([torch.zeros((n_seq, 1, 3), dtype=ts.dtype, device=dev),
                     ts], 1),
        q=torch.cat([q0[:, None], qs], 1),
        stats=_stack(stats, StepStats, 1),
        records=_stack(records, StepRecord, 1),
    )
