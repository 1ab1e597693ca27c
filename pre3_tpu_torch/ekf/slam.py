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

The reference's jitted ``lax.scan`` is a step program
(``utils/graphs.py``) keyed by one step's shapes: on the card each step
is one replay of a captured CUDA graph that reads the step's frame and
draws from its input row and updates the carry in place; on the CPU the
same step runs eagerly. Nothing is read back to the host. Its
``lax.cond`` on VO success is a ``torch.where`` over both branches; its
``lax.cond`` on the step number (the periodic attitude update) is
decided from the loop's host-side index, which picks the program's
graph with the plane fit, so the 512-hypothesis fit runs on 1 step in N
only. JAX's threefry draws
cannot be reproduced in torch, so every random draw is an input
(``draws=``) or comes from a ``torch.Generator``.

While the tracer is on (``utils/profiling``) ``slam_step`` marks its
stages with device probes (``STAGES``; a stage the configuration skips
marks nothing), each stage running from its probe to the next:
``slam_step.vo`` (the draws and ``vo_pair`` with its covariance),
``.predict`` (the prediction and the v/ω refresh), ``.match`` (the
measurement prediction and the map matching), ``.ransac`` (1-point
RANSAC), ``.update`` (the li update, the hi rescue and the hi update),
``.map`` (bookkeeping, deletion, conversion, adds and the attitude
update) and ``.out`` (the step's outputs, to the program's ``.end``
probe). ``run_slam`` is a span and a request of its own, with the spans
``bootstrap_state`` and ``scan.stage_rows`` (packing ``STAGE_ROWS``
steps' input rows) inside.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.func import jacfwd
from torch.utils._pytree import tree_map

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
from pre3_tpu_torch.ekf.prediction import predict, predict_cv, process_noise_on
from pre3_tpu_torch.ekf.state import CAM_DIM, EkfState, init_state
from pre3_tpu_torch.ekf.update import (
    attitude_update, iterated_kalman_update, kalman_update,
)
from pre3_tpu_torch.frontend.pipeline import Features
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.geometry.quaternion import q2v, qrotate, v2q
from pre3_tpu_torch.utils import profiling
from pre3_tpu_torch.utils.graphs import (
    STAGE_ROWS, Packing, StepProgram, call_program, empty_like_tree, load,
    packed_result, program, shape_key,
)
from pre3_tpu_torch.vo.dead_reckoning import vo_pair
from pre3_tpu_torch.vo.ransac import _draw_gumbel

# slam_step's stages, in the order their probes fire (see the module
# docstring); "out" runs to the step program's end probe
STAGES = ("vo", "predict", "match", "ransac", "update", "map", "out")


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


def draw_shapes(cfg: SlamConfig, n_feats: int,
                n_landmarks: int) -> StepDraws:
    """The shape of each draw a step takes from its generator under
    ``cfg``, in the order it takes them (None: not drawn there): VO
    RANSAC [vo_batch, n_feats], 1-PRE [ransac_batch, pool] and add
    sampling [n_feats] ("weighted" only). The attitude update's plane
    fit stays with ``floor_up_direction``."""
    ms = cfg.max_update_slots if cfg.max_update_slots > 0 else None
    return StepDraws(
        vo=(cfg.vo_batch, n_feats) if cfg.motion_model != "cv" else None,
        ransac=(cfg.ransac_batch, pool_size(n_landmarks, ms))
        if cfg.est_method not in ("pure_ekf", "iekf")
        and not cfg.only_predict else None,
        add=(n_feats,) if cfg.init_sampling == "weighted" else None,
    )


def draw_step(
    cfg: SlamConfig,
    n_feats: int,
    n_landmarks: int,
    generator: torch.Generator | None,
    device: torch.device | str,
    draws: StepDraws | None = None,
) -> StepDraws:
    """One step's draws: the fields ``draws`` sets, and every other draw
    the step consumes under ``cfg`` (``draw_shapes``) taken from
    ``generator`` in the order slam_step consumes them. The attitude
    update's plane fit, the step's last draw, stays with
    ``floor_up_direction``. Without a generator the missing fields stay
    None."""
    d = StepDraws() if draws is None else draws
    if generator is None:
        return d
    shapes = draw_shapes(cfg, n_feats, n_landmarks)
    return StepDraws(*(
        f if f is not None or shape is None
        else _draw_gumbel(shape, generator, device=device)
        for f, shape in zip(d[:3], shapes[:3])), heading=d.heading)


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
    if cfg.motion_model != "cv":
        profiling.probe("slam_step.vo", dev)
    draws = draw_step(cfg, frame.uv.shape[0], state.n_landmarks, generator,
                      dev, draws)

    # 1. VO control input + prediction, with the estimated VO covariance
    # (mapped [dt, dω] → [dX, dq]) plus the reference's floor as noise
    if cfg.motion_model == "cv":
        profiling.probe("slam_step.predict", dev)
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
        profiling.probe("slam_step.predict", dev)
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
            pn = j @ vo.cov @ j.T + process_noise_on(dev)
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
    profiling.probe("slam_step.match", dev)
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
        profiling.probe("slam_step.update", dev)
        li, hi = obs.ic, none
        state = kalman_update(state, obs, li, std_z=cfg.std_z, max_slots=ms)
    elif cfg.est_method == "iekf":
        # iterated EKF on every IC match, relinearized at each iterate
        profiling.probe("slam_step.update", dev)
        li, hi = obs.ic, none
        state = iterated_kalman_update(cam_model, state, obs.z, li,
                                       std_z=cfg.std_z)
    else:
        # 1PRE: li update on the prior, then hi rescue on the posterior
        profiling.probe("slam_step.ransac", dev)
        li = one_point_ransac(
            cam_model, state, obs, batch=cfg.ransac_batch, std_z=cfg.std_z,
            n_points=cfg.ransac_points, max_slots=ms, gumbel=draws.ransac,
        )
        profiling.probe("slam_step.update", dev)
        state = kalman_update(state, obs, li, std_z=cfg.std_z, max_slots=ms)
        hi, obs2 = rescue_hi_inliers(cam_model, state, obs, li,
                                     std_z=cfg.std_z)
        state = kalman_update(state, obs2, hi, std_z=cfg.std_z, max_slots=ms)

    # 5. bookkeeping
    profiling.probe("slam_step.map", dev)
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
    profiling.probe("slam_step.out", dev)
    return state, (stats, record)


def bootstrap_body(
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
    """``bootstrap_state``'s plain body: the filter initialized and the
    map seeded from frame 0 as plain ops. A body captured into another
    program that needs a bootstrap calls this, never the program."""
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


def _bootstrap_call(cam_model: Camera, cfg: SlamConfig, n_landmarks: int,
                    args: tuple, generator: torch.Generator | None):
    """One run of the bootstrap's program on one frame's ``args`` =
    (first, xyz_img, image, plane_gumbel, add_gumbel), None where absent,
    copied into its input buffers. Keyed by the camera, cfg,
    ``n_landmarks``, whether a generator draws and the args' shapes.
    Returns (the program, its state packing): the output row holds the
    packed state."""
    first, drawing = args[0], generator is not None
    pstate = Packing(init_state(n_landmarks, first.desc.shape[-1],
                                dtype=first.desc.dtype, device="meta"))
    prog = call_program("bootstrap_state", (cam_model, cfg, n_landmarks,
                                            drawing), args, pstate,
                        n_generators=int(drawing))

    def body(b, gens):
        first, xyz_img, image, plane_gumbel, add_gumbel = b["inp"]
        pstate.pack(bootstrap_body(
            cam_model, Features(*first), cfg, n_landmarks, xyz_img, image,
            plane_gumbel, add_gumbel, gens[0] if gens else None), b["out"])

    prog.run("bootstrap", body, [] if generator is None else [generator])
    return prog, pstate


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
    the gravity-aligned plane-fit prior (identity when the fit fails).

    The reference compiles its bootstrap (inside ``run_slam``'s jit, as
    ``OnlineSlam``'s boot program, in the stage pipeline). Here it is a
    step program (``utils/graphs.py``) whose body is ``bootstrap_body``:
    the frame and the injected draws copied in, one graph replay on the
    card (the generator registered with it, so a replay draws what the
    eager body draws at the same generator state), the state copied out
    of the program's output row with one copy; eager on the CPU. The
    returned state is the call's own."""
    with profiling.span("bootstrap_state"):
        prog, pstate = _bootstrap_call(
            cam_model, cfg, n_landmarks,
            (first, xyz_img, image, plane_gumbel, add_gumbel), generator)
        return packed_result(prog, pstate)


def _frame(feats: Features, i: int) -> Features:
    return Features(*(x[i] for x in feats))


def _row(x: torch.Tensor | None, i: torch.Tensor, dim: int = 0):
    """Entry ``i`` ([1] int64 on x's device) of x's axis ``dim``: a
    gather at a device index, which a captured step reads anew on every
    replay."""
    return None if x is None else x.index_select(dim, i).squeeze(dim)


def step_outputs_like(state: EkfState, lead: tuple = ()):
    """Empty (t, q, StepStats, StepRecord) of one step of ``state``'s
    shapes (one sequence's), with leading axes ``lead``."""
    dev, dt, k = state.x.device, state.x.dtype, state.n_landmarks

    def e(shape, dtype=dt):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    i32, b = torch.int32, torch.bool
    return (e((3,)), e((4,)),
            StepStats(e((), i32), e((), i32), e((), i32), e((), i32),
                      e((), i32), e((), b), e((), i32), e((), i32)),
            StepRecord(e((k, 2)), e((k, 3)), e((k,), b), e((k,), i32),
                       e((k,), b)))


def _first(x: torch.Tensor | None):
    return None if x is None else x[0]


def _slice(x: torch.Tensor | None, lo: int, hi: int, dim: int = 0):
    """x[lo:hi] along ``dim``, moved to the front."""
    return None if x is None else x.narrow(dim, lo, hi - lo).movedim(dim, 0)


def _scan_body(cam_model: Camera, cfg: SlamConfig, pin: Packing,
               pout: Packing):
    """``scan_steps``' step over a program's buffers, per variant (with
    the attitude update's plane fit or not): the step's frame, index,
    draws and images from the input row, the previous frame and the
    state from the carry, ``slam_step``, the outputs into the output
    row, the new state and the frame into the carry. The variant stands
    in for the host index (``host_step`` 0 fits, 1 does not)."""

    def make(fit: bool):
        def body(b, gens):
            frame, step, d, image, xyz = pin.unpack(b["inp"])
            state, (stats, record) = slam_step(
                cam_model, EkfState(*b["state"]), Features(*frame),
                Features(*b["prev"]), step, cfg,
                draws=d if fit else d._replace(heading=None),
                generator=gens[0] if gens else None, image=image,
                xyz_img=xyz, host_step=0 if fit else 1)
            pout.pack((state.x[0:3], state.x[3:7], stats, record),
                      b["out"])
            load(b["state"], state)
            load(b["prev"], frame)

        return body

    return make


def _scan(cam_model, state, prev_last, feats, steps, cfg, draws, generator,
          xyz_imgs, first_step, images):
    """``scan_steps``' runs: (the program, whose carry holds the final
    state, and the call's stacked outputs as views of its rows)."""
    c = feats.uv.shape[0]
    every = cfg.heading_update_every
    if every > 0 and first_step is None:
        raise ValueError("heading_update_every > 0 needs per-frame xyz "
                         "images and the step's host index (host_step)")
    fits = [every > 0 and (first_step + i) % every == 0 for i in range(c)]
    draws = StepDraws() if draws is None else draws
    if any(fits) and draws.heading is not None and (
            draws.heading.shape[0] < sum(fits)):
        raise ValueError(f"draws.heading holds {draws.heading.shape[0]} "
                         f"plane fits for the {sum(fits)} this chunk runs")
    heading = draws.heading if any(fits) else None
    dev = steps.device
    one = (_frame(feats, 0), steps[0],
           StepDraws(*map(_first, draws[:3]), _first(heading)),
           _first(images), _first(xyz_imgs))
    pin = Packing(one)
    pout = Packing(step_outputs_like(state))

    def make():
        bufs = dict(state=empty_like_tree(state),
                    prev=empty_like_tree(one[0]),
                    inp=pin.rows(device=dev), out=pout.rows(device=dev))
        return StepProgram("scan_steps", bufs, dev,
                           int(generator is not None),
                           carry=("state", "prev"))

    prog = program(("scan_steps", cam_model, cfg, generator is not None,
                    shape_key(state, one)), make)
    b = prog.buffers
    load((b["state"], b["prev"]), (state, prev_last))
    gens = [] if generator is None else [generator]
    body = _scan_body(cam_model, cfg, pin, pout)
    in_rows = pin.rows(min(c, STAGE_ROWS), device=dev)
    out_rows = pout.rows(c, device=dev)
    n_fit = 0
    for lo in range(0, c, STAGE_ROWS):
        hi = min(c, lo + STAGE_ROWS)
        rows = in_rows[:hi - lo]
        with profiling.span("scan.stage_rows"):
            frame, step, d, image, xyz = pin.unpack(rows)
            load((frame, step, d._replace(heading=None), image, xyz), (
                Features(*(_slice(x, lo, hi) for x in feats)), steps[lo:hi],
                StepDraws(*(_slice(x, lo, hi) for x in draws[:3])),
                _slice(images, lo, hi), _slice(xyz_imgs, lo, hi)))
            if heading is not None:  # the plane fits' draws, in fit order
                for i in range(lo, hi):
                    if fits[i]:
                        d.heading[i - lo].copy_(heading[n_fit])
                        n_fit += 1
        prog.run_rows(fits[lo:hi], body, rows, out_rows[lo:hi], gens)
    return prog, pout.unpack(out_rows)


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
    Returns (state, (t [C, 3], q [C, 4], stats, records)).

    The port's ``lax.scan``: a step program (``utils/graphs.py``) keyed
    by (camera, cfg, one step's shapes and dtypes, device, injected
    draws), so one program serves chunks of every length. It owns one
    step's input row (frame, step index, draws, images), the carry (the
    state and the previous frame) and one step's output row. Per step
    the host copies the step's packed inputs into the input row, runs
    the step (``slam_step``, the outputs into the output row, the new
    state and the frame into the carry in place) and copies the output
    row into the call's storage. On the card each run is one replay of a
    captured CUDA graph (two graphs where the attitude update runs: the
    host picks the one with the plane fit by its step index, and packs
    the fit's draws into that step's row); on the CPU the same step runs
    eagerly. The inputs are packed ``STAGE_ROWS`` steps at a time. The
    returned state is a copy of the carry, and the outputs live in the
    call's own storage: a later call, which reuses the program's buffers
    in place as JAX's donated carry reuses its input, changes neither."""
    prog, (ts, qs, stats, records) = _scan(
        cam_model, state, prev_last, feats, steps, cfg, draws, generator,
        xyz_imgs, first_step, images)
    contiguous = lambda x: x.contiguous()  # noqa: E731
    return (EkfState(*(x.clone() for x in prog.buffers["state"])),
            (ts.contiguous(), qs.contiguous(), tree_map(contiguous, stats),
             tree_map(contiguous, records)))


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
    the random draws; whatever it leaves None comes from ``generator``.
    The bootstrap runs as its program (``bootstrap_state``), the F−1
    steps as ``scan_steps``' program: on the card one graph replay for
    the bootstrap and one per step. A span and a request of the tracer
    (see the module docstring)."""
    with profiling.span("run_slam", request=True):
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
        _, (ts, qs, stats, records) = _scan(
            cam_model, state0, first, rest, steps, cfg, draws.steps, generator,
            None if xyz_imgs is None else xyz_imgs[1:], 1,
            None if images is None else images[1:])
        contiguous = lambda x: x.contiguous()  # noqa: E731
        return SlamTrajectory(
            t=torch.cat([torch.zeros((1, 3), dtype=ts.dtype, device=dev), ts]),
            q=torch.cat([state0.x[3:7][None], qs]),  # identity, or the prior
            stats=tree_map(contiguous, stats),
            records=tree_map(contiguous, records),
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
    (no plane-fit prior: the batched path takes no xyz images): S runs of
    the one bootstrap program, sequence s with ``generators[s]``, each
    state copied from the program's output row into row s of the call's
    own storage."""
    _check_batched(cfg)
    n_seq = first.uv.shape[0]

    rows = None
    for s in range(n_seq):
        prog, pstate = _bootstrap_call(
            cam_model, cfg, n_landmarks,
            (Features(*(x[s] for x in first)), None, None, None,
             None if boot_add is None else boot_add[s]),
            None if generators is None else generators[s])
        if rows is None:
            rows = pstate.rows(n_seq, device=first.uv.device)
        rows[s].copy_(prog.buffers["out"])
    return pstate.unpack(rows)


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


# Steps of draws the S generators make in one run of run_slam_batched's
# draw variants, ahead of the steps that read them.
DRAW_BLOCK = 16


def _blocks(n: int) -> list[int]:
    """n as a sum of powers of two, largest first: the draw variants that
    fill n steps' draws."""
    return [1 << k for k in reversed(range(n.bit_length())) if n >> k & 1]


def _batched_bodies(cam_model: Camera, cfg: SlamConfig, n_landmarks: int,
                    pin: Packing, pout: Packing):
    """``run_slam_batched``' variants over a program's buffers, by
    variant: ("draw", n) draws n steps' draws from the S generators into
    the draw block at the device write index, in the order the eager
    loop draws them; "step" reads the step's frames, index and injected
    draws from the input row, its drawn draws from the block at the
    device read index, runs ``slam_step_batched``, writes the outputs
    into the output row and the new states and frames into the carry."""

    def make(variant):
        if variant == "step":
            def body(b, gens):
                frame, step, inj = pin.unpack(b["inp"])
                j = b["jb"][0:1]
                d = StepDraws(*(x if buf is None else _row(buf, j)
                                for x, buf in zip(inj, b["drawn"])))
                state, (stats, record) = slam_step_batched(
                    cam_model, EkfState(*b["state"]), Features(*frame),
                    Features(*b["prev"]), step, cfg, d)
                pout.pack((state.x[:, 0:3], state.x[:, 3:7], stats, record),
                          b["out"])
                load(b["state"], state)
                load(b["prev"], frame)
                j.add_(1)

            return body

        _, n = variant

        def draw(b, gens):
            frame, _, inj = pin.unpack(b["inp"])
            base = b["jb"][1:2]
            for m in range(n):
                d = draw_batched(cfg, frame.uv.shape[1], n_landmarks, gens,
                                 frame.uv.device, inj)
                for buf, x in zip(b["drawn"], d):
                    if buf is not None:
                        buf.index_copy_(0, base + m, x[None])
            base.add_(n)

        return draw

    return make


def scan_steps_batched(
    cam_model: Camera,
    state: EkfState,  # the S bootstrapped states, leading axis S
    feats: Features,  # stacked, leading axes [S, F]
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    draws: StepDraws | None = None,  # fields with leading axes [S, F−1]
    generators: list[torch.Generator] | None = None,
):
    """``run_slam_batched``' F−1 steps from its bootstrapped states:
    (t [S, F−1, 3], q [S, F−1, 4], stats, records), each with leading
    axes [S, F−1].

    A step program (``utils/graphs.py``) keyed by one step's shapes, as
    ``scan_steps``' is: one graph replay per step on the card, eager on
    the CPU. The S generators' draws are made ``DRAW_BLOCK`` steps ahead
    by the program's draw variants (graphs of 1, 2, 4, … steps' draws,
    so a block of any length takes at most log₂ DRAW_BLOCK + 1 of them),
    each generator's in the order the eager loop of ``draw_batched``
    takes them: the host seeds the S registered generators once per draw
    run, not once per step."""
    _check_batched(cfg)
    n_seq, n_frames = feats.uv.shape[:2]
    n_steps = n_frames - 1
    dev = feats.uv.device
    steps = torch.arange(1, n_frames, dtype=torch.int32, device=dev)
    gens = list(generators or [])
    inj = StepDraws() if draws is None else draws
    one = (Features(*(x[:, 0] for x in feats)), steps[0],
           StepDraws(*(None if x is None else x[:, 0] for x in inj)))
    pin = Packing(one)
    pout = Packing(step_outputs_like(EkfState(*(x[0] for x in state)),
                                     (n_seq,)))
    shapes = draw_shapes(cfg, feats.uv.shape[2], n_landmarks)

    def make():
        drawn = StepDraws(*(
            None if x is not None or shape is None or not gens
            else torch.empty((DRAW_BLOCK, n_seq, *shape), device=dev)
            for x, shape in zip(inj[:3], shapes[:3])))
        bufs = dict(state=empty_like_tree(state),
                    prev=empty_like_tree(one[0]), inp=pin.rows(device=dev),
                    out=pout.rows(device=dev), drawn=drawn,
                    jb=torch.zeros(2, dtype=torch.int64, device=dev))
        return StepProgram("run_slam_batched", bufs, dev, len(gens),
                           carry=("state", "prev", "jb"))

    prog = program(("run_slam_batched", cam_model, cfg, n_landmarks,
                    len(gens), shape_key(state, one)), make)
    b = prog.buffers
    load((b["state"], b["prev"]), (state, one[0]))
    bodies = _batched_bodies(cam_model, cfg, n_landmarks, pin, pout)
    in_rows = pin.rows(min(n_steps, DRAW_BLOCK), device=dev)
    out_rows = pout.rows(n_steps, device=dev)
    for lo in range(0, n_steps, DRAW_BLOCK):
        hi = min(n_steps, lo + DRAW_BLOCK)
        rows = in_rows[:hi - lo]
        pin.pack((Features(*(_slice(x, lo + 1, hi + 1, 1) for x in feats)),
                  steps[lo:hi],
                  StepDraws(*(_slice(x, lo, hi, 1) for x in inj))), rows)
        if gens:
            b["jb"].zero_()
            for n in _blocks(hi - lo):
                prog.run(("draw", n), bodies(("draw", n)), gens)
        prog.run_rows(["step"] * (hi - lo), bodies, rows, out_rows[lo:hi])
    seq_major = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
    return tree_map(seq_major, pout.unpack(out_rows))


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
    ``slam_step_batched``, so K1 and K2 launch once per step for all S
    (``scan_steps_batched``: one graph replay per step on the card).

    ``draws``: a SlamDraws whose fields carry a leading S axis; whatever
    it leaves None comes from ``generators[s]``, one per sequence, drawn
    outside the vmap (``draw_batched``) in the order a single run_slam
    draws it, so sequence s matches ``run_slam(..., generator=
    generators[s])``. Returns a SlamTrajectory whose fields have a
    leading S axis. The descriptor matcher only, without the periodic
    attitude update (no per-frame images)."""
    _check_batched(cfg)
    n_seq = feats.uv.shape[0]
    if generators is not None and len(generators) != n_seq:
        raise ValueError(f"run_slam_batched: {len(generators)} generators "
                         f"for {n_seq} sequences")
    draws = SlamDraws(steps=StepDraws()) if draws is None else draws
    state = bootstrap_batched(cam_model, Features(*(x[:, 0] for x in feats)),
                              cfg, n_landmarks, draws.boot_add, generators)
    ts, qs, stats, records = scan_steps_batched(
        cam_model, state, feats, cfg, n_landmarks, draws.steps, generators)
    return SlamTrajectory(
        t=torch.cat([torch.zeros_like(ts[:, :1]), ts], 1),
        q=torch.cat([state.x[:, None, 3:7], qs], 1),
        stats=stats, records=records,
    )
