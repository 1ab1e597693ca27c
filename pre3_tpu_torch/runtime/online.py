"""Online streaming SLAM driver: frames in one at a time, poses out.

Port of ``pre3_tpu/runtime/online.py::OnlineSlam``. The reference fuses
each frame's pipeline (frontend, VO, EKF step, map management) into one
jitted program and keeps the step counter and PRNG key in its
device-resident carry, so the host dispatches and never waits. Here the
same pipeline runs eagerly and the host never waits either:

  * a frame is staged through pinned host buffers and copied to the card
    with ``non_blocking=True`` (a pageable copy would wait for the card
    every frame). A buffer is reused only once the event recorded after
    its copy has passed; while none has, another is allocated;
  * the step counter lives on the device, beside the EKF state and the
    previous frame's features; the host keeps the same index as a Python
    integer, which decides the periodic attitude update's steps;
  * nothing is read back: results are device tensors, and reading them
    (``trajectory``) is what synchronises.

Random draws come from ``generator`` (a ``torch.Generator`` on the
device, the port's counterpart of the reference's key) or, per call, from
``draws``. ``process_chunk`` runs C frames as one frontend batch and one
``scan_steps``. Each step's ``StepRecord`` is kept on the device;
``smooth()`` brings them to the host once and runs the keyframe BA
backend over them. Snapshots every ``snapshot_every`` steps
(``utils/checkpoint.py``) carry the generator's state, so a resumed run
continues the same stream.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from pre3_tpu_torch.ekf.slam import (
    SlamConfig, SlamDraws, SlamTrajectory, StepDraws, StepRecord, StepStats,
    _frame, bootstrap_state, scan_steps, slam_step,
)
from pre3_tpu_torch.ekf.state import EkfState
from pre3_tpu_torch.frontend.pipeline import (
    extract_features, extract_features_sift,
)
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.utils.device import to_device
from pre3_tpu_torch.utils.profiling import StageTimer

# Pinned staging sets kept per frame shape; past this many in flight the
# upload waits for the oldest copy instead of allocating another.
MAX_STAGING = 8


class StepResult(NamedTuple):
    step: int
    t: torch.Tensor  # [3] device tensor (lazy)
    q: torch.Tensor  # [4]
    stats: StepStats | None


class _Slot:
    """Pinned host buffers for one upload and the event recorded after
    their copies (a fresh event counts as passed)."""

    def __init__(self, shapes) -> None:
        self.bufs = [torch.empty(s, dtype=torch.float32, pin_memory=True)
                     for s in shapes]
        self.event = torch.cuda.Event()


class _Staging:
    """Host → device frame uploads that never wait for the card: a ring
    of pinned slots per input shape, least recently used first. On a CPU
    device the arrays are only converted to float32 tensors."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._rings: dict[tuple, list[_Slot]] = {}

    def __call__(self, *arrays) -> tuple[torch.Tensor, ...]:
        if self.device.type != "cuda":
            return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                         .to(self.device) for a in arrays)
        shapes = tuple(tuple(np.shape(a)) for a in arrays)
        ring = self._rings.setdefault(shapes, [])
        slot = next((s for s in ring if s.event.query()), None)
        if slot is None and len(ring) >= MAX_STAGING:
            slot = ring[0]
            slot.event.synchronize()
        if slot is None:
            slot = _Slot(shapes)
        else:
            ring.remove(slot)
        ring.append(slot)
        for buf, a in zip(slot.bufs, arrays):
            buf.copy_(torch.from_numpy(np.asarray(a)))
        out = tuple(b.to(self.device, non_blocking=True) for b in slot.bufs)
        slot.event.record()
        return out


class OnlineSlam:
    """Feed frames one at a time; poses stream out.

    >>> slam = OnlineSlam(cam)
    >>> for fr in frames:
    ...     res = slam.process(fr.intensity, fr.xyz, fr.confidence)
    """

    def __init__(
        self,
        cam: Camera,
        cfg: SlamConfig = SlamConfig(),
        n_landmarks: int = 64,
        extractor: str = "fast",
        extractor_kwargs: dict[str, Any] | None = None,
        generator: torch.Generator | None = None,
        snapshot_dir: str | None = None,
        snapshot_every: int = 0,
        timer: StageTimer | None = None,
        sync_timing: bool = False,
        device: torch.device | str = "cuda",
    ) -> None:
        self.cam = cam
        self.cfg = cfg
        self.n_landmarks = n_landmarks
        self.device = torch.device(device)
        self.timer = timer or StageTimer()
        self.sync = sync_timing
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.generator = generator if generator is not None else (
            torch.Generator(device=self.device).manual_seed(0))
        ek = dict(extractor_kwargs or {})
        if extractor == "fast":
            self._extract = partial(extract_features, **ek)
        elif extractor == "sift":
            self._extract = partial(extract_features_sift, **ek)
        else:
            raise ValueError(f"unknown extractor {extractor!r}")
        # the NCC matcher reads the intensity image (and samples the xyz
        # image at its matches); the periodic floor-plane attitude update
        # needs the xyz image on the descriptor path too
        self._needs_image = cfg.matcher == "ncc_warp"
        self._needs_xyz = self._needs_image or cfg.heading_update_every > 0
        self._upload = _Staging(self.device)
        # carry = (EkfState, step int32 [] on the device, previous frame's
        # Features); step_i is the same step as a host integer
        self._carry: tuple | None = None
        self.step_i = 0
        self.results: list[StepResult] = []
        # each step's StepRecord as device tensors with a leading step axis
        # (1 per frame, C per chunk): the smoother's input, as run_slam
        # emits it
        self._records: list[StepRecord] = []

    @property
    def state(self) -> EkfState | None:
        return None if self._carry is None else self._carry[0]

    # -- streaming ----------------------------------------------------------

    def process(self, intensity, xyz, confidence,
                draws: SlamDraws | StepDraws | None = None) -> StepResult:
        """Feed one frame ([H, W], [H, W, 3], [H, W] host arrays: numpy
        or CPU tensors). Returns device pose tensors: reading them
        synchronises, not reading them keeps the card busy. ``draws``
        overrides the generator: a SlamDraws (its ``plane`` and
        ``boot_add``) for the bootstrap frame, a StepDraws for the
        others."""
        boot = self._carry is None
        if not boot:
            state, step, prev = self._primed()
        with self.timer.stage("dispatch"):
            img, xyz_d, conf = self._upload(intensity, xyz, confidence)
            feats = _frame(self._extract(img[None], xyz_d[None],
                                         conf[None]), 0)
            if boot:
                boot = draws if draws is not None else SlamDraws(StepDraws())
                state = bootstrap_state(
                    self.cam, feats, self.cfg, self.n_landmarks,
                    xyz_img=xyz_d,
                    image=img if self._needs_image else None,
                    plane_gumbel=boot.plane,
                    add_gumbel=boot.boot_add, generator=self.generator)
                step = torch.ones((), dtype=torch.int32, device=self.device)
                res = StepResult(0, state.x[0:3], state.x[3:7], None)
            else:
                state, (stats, rec) = slam_step(
                    self.cam, state, feats, prev, step, self.cfg,
                    draws=draws, generator=self.generator,
                    image=img if self._needs_image else None,
                    xyz_img=xyz_d if self._needs_xyz else None,
                    host_step=self.step_i)
                self._records.append(StepRecord(*(x[None] for x in rec)))
                step = step + 1
                res = StepResult(self.step_i, state.x[0:3], state.x[3:7],
                                 stats)
            self._carry = (state, step, feats)
            if self.sync:
                _synchronize(self.device)
        self._advance([res])
        return res

    def process_chunk(self, intensity, xyz, confidence,
                      draws: StepDraws | None = None) -> list[StepResult]:
        """Feed C frames (host arrays with leading axis C) as one
        frontend batch and one scan over the EKF steps. Must follow the bootstrap frame, which
        process() takes. ``draws``: stacked StepDraws for the C steps."""
        if self._carry is None:
            raise RuntimeError("bootstrap with process() before chunks")
        state, step, prev = self._primed()
        c = np.shape(intensity)[0]
        with self.timer.stage("dispatch"):
            img, xyz_d, conf = self._upload(intensity, xyz, confidence)
            feats = self._extract(img, xyz_d, conf)
            steps = step + torch.arange(c, dtype=torch.int32,
                                        device=self.device)
            state, (ts, qs, stats, recs) = scan_steps(
                self.cam, state, prev, feats, steps, self.cfg, draws=draws,
                generator=self.generator,
                xyz_imgs=xyz_d if self._needs_xyz else None,
                first_step=self.step_i,
                images=img if self._needs_image else None)
            self._records.append(recs)
            self._carry = (state, step + c, _frame(feats, c - 1))
            if self.sync:
                _synchronize(self.device)
        out = [StepResult(self.step_i + i, ts[i], qs[i],
                          StepStats(*(x[i] for x in stats)))
               for i in range(c)]
        self._advance(out)
        return out

    def _primed(self):
        state, step, prev = self._carry
        if prev is None:
            raise RuntimeError(
                "previous-frame features are unset — call prime() after "
                "resume() before streaming frames")
        return state, step, prev

    def _advance(self, out: list[StepResult]) -> None:
        self.step_i += len(out)
        self.results.extend(out)
        if (self.snapshot_dir and self.snapshot_every
                and self.step_i % self.snapshot_every == 0):
            self.snapshot()

    def run(
        self,
        frames: Iterable,
        decode: Callable[[Any], tuple] | None = None,
        prefetch: int = 2,
        chunk: int = 1,
    ) -> list[StepResult]:
        """Drive a whole sequence with host-side decode prefetch.

        ``decode(frame) -> (intensity, xyz, confidence)`` runs in a
        background thread ``prefetch`` frames ahead (attribute access for
        Frame-like objects by default). chunk > 1 batches that many frames
        per process_chunk after the per-frame bootstrap."""
        if decode is None:
            def decode(f):
                return f.intensity, f.xyz, f.confidence

        it: Iterator = iter(frames)
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = [pool.submit(decode, f)
                       for f in itertools.islice(it, prefetch)]
            buf: list[tuple] = []
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(decode, nxt))
                with self.timer.stage("decode_wait"):
                    args = fut.result()
                if chunk <= 1 or self._carry is None:
                    self.process(*args)
                    continue
                buf.append(args)
                if len(buf) == chunk or not pending:
                    self.process_chunk(*(np.stack([a[j] for a in buf])
                                         for j in range(3)))
                    buf = []
        return self.results

    # -- persistence --------------------------------------------------------

    def snapshot(self) -> str:
        """Write the filter state, step and generator state (reads the
        state back from the card)."""
        from pre3_tpu_torch.utils.checkpoint import save_state

        path = f"{self.snapshot_dir}/snapshot_{self.step_i:05d}.npz"
        save_state(path, self._carry[0], self.step_i, self.generator)
        return path

    def resume(self, path: str) -> None:
        """Restore state, step and generator state from a snapshot. The
        previous frame's features are not checkpointed: call prime() with
        frame step_i − 1 before the next process()."""
        from pre3_tpu_torch.utils.checkpoint import load_state

        state, self.step_i, gen_state, _ = load_state(path, self.device)
        if gen_state is not None:
            self.generator.set_state(gen_state)
        step = to_device(torch.tensor(self.step_i, dtype=torch.int32),
                         self.device)
        self._carry = (state, step, None)

    def prime(self, intensity, xyz, confidence) -> None:
        """Set the previous frame's features after resume()."""
        img, xyz_d, conf = self._upload(intensity, xyz, confidence)
        feats = _frame(self._extract(img[None], xyz_d[None], conf[None]), 0)
        state, step, _ = self._carry
        self._carry = (state, step, feats)

    # -- sliding-window smoothing -------------------------------------------

    def _stacked_records(self) -> StepRecord:
        """The recorded StepRecords stacked to numpy with leading axis
        F-1 (row r is frame r+1, as run_slam's records): one copy to the
        host."""
        return StepRecord(*(torch.cat(xs).cpu().numpy()
                            for xs in zip(*self._records)))

    def smooth(
        self,
        window: int | None = None,
        max_keyframes: int = 32,
        iters: int = 8,
        max_landmarks: int = 256,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-lag smoother over the streamed trajectory: keyframes are
        selected inside the trailing ``window`` frames (None: the whole
        history), a Schur-complement BA runs on the recorded filter-vetted
        observations (``backend/ekf_ba.py``, as the offline path), and the
        corrections are interpolated back onto every frame of the window;
        frames before it are left as they are. Returns (t [F, 3],
        q [F, 4]) as numpy. Synchronises: the trajectory and the records
        come to the host once; the BA runs on this OnlineSlam's device.
        Records are not checkpointed: after resume() the smoothable window
        restarts."""
        from pre3_tpu_torch.backend.ba import bundle_adjust
        from pre3_tpu_torch.backend.ekf_ba import ba_problem_from_slam
        from pre3_tpu_torch.backend.keyframes import select_keyframes
        from pre3_tpu_torch.backend.smoothing import apply_ba_corrections

        ts, qs = self.trajectory
        f = len(ts)
        if f < 3 or not self._records:
            return ts, qs
        records = self._stacked_records()
        lo = max(0, f - window) if window else 0
        dev = self.device
        traj = SlamTrajectory(
            t=torch.as_tensor(ts[lo:]).to(dev),
            q=torch.as_tensor(qs[lo:]).to(dev), stats=None,
            records=StepRecord(*(x[lo:] for x in records)))
        ks = select_keyframes(traj.t, traj.q,
                              torch.ones(f - lo, dtype=torch.bool, device=dev),
                              max_keyframes=max_keyframes)
        prob = ba_problem_from_slam(traj, ks.indices.cpu().numpy(),
                                    ks.valid.cpu().numpy(),
                                    max_landmarks=max_landmarks)
        if prob is None:
            return ts, qs
        res = bundle_adjust(self.cam, prob, iters=iters)
        sm_t, sm_q = apply_ba_corrections(traj.t, traj.q, ks.indices,
                                          ks.valid, res.kf_t, res.kf_q)
        out_t, out_q = ts.copy(), qs.copy()
        out_t[lo:] = sm_t.cpu().numpy()
        out_q[lo:] = sm_q.cpu().numpy()
        return out_t, out_q

    # -- views ---------------------------------------------------------------

    @property
    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """([F, 3], [F, 4]) — synchronizes."""
        ts = torch.stack([r.t for r in self.results]).cpu().numpy()
        qs = torch.stack([r.q for r in self.results]).cpu().numpy()
        return ts, qs


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
