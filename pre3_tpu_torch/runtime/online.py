"""Online streaming SLAM driver: frames in one at a time, poses out.

Port of ``pre3_tpu/runtime/online.py::OnlineSlam``. The reference runs
each frame's pipeline (frontend, VO, EKF step, map management) as one
jitted program whose carry (state, PRNG key, step, previous frame's
features) is donated and stays on the device, so the host dispatches
once per frame and never waits. Here:

  * each frame after the bootstrap is one step program
    (``utils/graphs.py``), this instance's own: on the card one replay of
    a captured CUDA graph holding the frontend, ``slam_step`` (K1 and K2
    inside), the carry's update in place and the step counter; on the
    CPU the same body (``fused_fn``) runs eagerly. The host issues the
    frame's three copies from a pinned staging slot into the program's
    input buffers, the generator fills, the graph launch and one copy of
    the step's packed outputs into a row of per-step storage;
  * the carry lives in the program's buffers: ``state`` aliases it, and
    the next ``process()`` overwrites it in place, as the reference's
    donated carry invalidates the state it was given (clone it to keep
    it). ``resume`` and ``prime`` copy into the carry, never rebind what
    the graph reads;
  * frames are staged through pinned host buffers and copied with
    ``non_blocking=True`` (a pageable copy would wait for the card every
    frame). A buffer is reused only once the event recorded after its
    copy has passed; while none has, another is allocated;
  * the step counter lives on the device; the host keeps the same index
    as a Python integer, which picks the program's variant with the
    periodic attitude update. ``PRE3_SIFT_FAST_MATH`` picks the
    frontend's branch per call, and a variant per value;
  * nothing is read back: results are device tensors, rows of per-step
    storage that no later frame overwrites, and reading them
    (``trajectory``) is what synchronises.

The bootstrap frame (``boot_fn``) runs once: the frontend's program at
one frame, then the bootstrap's (``bootstrap_state``), as the reference
runs its compiled boot program. The frame program's body
(``fused_fn``) calls the frontend's plain body (``fast_features`` or
``sift_features``): a program cannot run inside another's capture.
Random draws come from ``generator`` (a ``torch.Generator`` on the
device, the port's counterpart of the reference's key) or, per call,
from ``draws``.
``process_chunk`` runs C frames through the frontend's program (one
replay per chunk of up to 64 frames) and ``scan_steps``' program (one
replay per step). Each step's ``StepRecord`` is kept on the
device; ``smooth()`` brings them to the host once and runs the keyframe
BA backend over them. Snapshots every ``snapshot_every`` steps
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
    _frame, bootstrap_state, scan_steps, slam_step, step_outputs_like,
)
from pre3_tpu_torch.ekf.state import EkfState
from pre3_tpu_torch.frontend.pipeline import (
    Features, extract_features, extract_features_sift, fast_features,
    sift_features,
)
from pre3_tpu_torch.frontend.sift import _fast_math
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.utils.graphs import (
    Packing, StepProgram, empty_like_tree, load, shape_key,
)
from pre3_tpu_torch.utils.profiling import StageTimer

# Pinned staging sets kept per frame shape; past this many in flight the
# upload waits for the oldest copy instead of allocating another.
MAX_STAGING = 8
# Rows of per-step result storage allocated at a time.
STORE_ROWS = 64


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
    device the arrays are only converted to float32 tensors. With
    ``out`` the arrays are copied into those device tensors (a step
    program's input buffers) instead of new ones."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._rings: dict[tuple, list[_Slot]] = {}

    def __call__(self, *arrays, out=None) -> tuple[torch.Tensor, ...]:
        if self.device.type != "cuda":
            got = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                        .to(self.device) for a in arrays)
            if out is None:
                return got
            for o, g in zip(out, got):
                o.copy_(g)
            return out
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
        if out is None:
            out = tuple(b.to(self.device, non_blocking=True)
                        for b in slot.bufs)
        else:
            for o, b in zip(out, slot.bufs):
                o.copy_(b, non_blocking=True)
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
        # the frontend's program (the bootstrap, prime, process_chunk) and
        # its plain body (fused_fn, which the frame program captures)
        if extractor == "fast":
            self._extract = partial(extract_features, **ek)
            self._extract_body = partial(fast_features, **ek)
        elif extractor == "sift":
            self._extract = partial(extract_features_sift, **ek)
            self._extract_body = partial(sift_features, **ek)
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
        # this instance's frame programs and their output layouts (by
        # shapes and injected draws), and the block of per-step storage
        # rows being filled
        self.programs: dict[tuple, tuple[StepProgram, Packing]] = {}
        self._store: torch.Tensor | None = None
        self._store_used = 0

    @property
    def state(self) -> EkfState | None:
        """The filter state. After ``process()`` it aliases the frame
        program's live carry, which the next frame updates in place."""
        return None if self._carry is None else self._carry[0]

    # -- the per-frame functions (the reference's fused and boot) ----------

    def boot_fn(self, intensity, xyz, conf, draws: SlamDraws | None = None,
                generator: torch.Generator | None = None):
        """The bootstrap frame through the frontend's program and the
        bootstrap's: device frames [H, W], [H, W, 3], [H, W] → (state,
        step, feats, t, q)."""
        draws = draws if draws is not None else SlamDraws(StepDraws())
        feats = _frame(self._extract(intensity[None], xyz[None],
                                     conf[None]), 0)
        state = bootstrap_state(
            self.cam, feats, self.cfg, self.n_landmarks, xyz_img=xyz,
            image=intensity if self._needs_image else None,
            plane_gumbel=draws.plane, add_gumbel=draws.boot_add,
            generator=generator)
        step = torch.ones((), dtype=torch.int32, device=intensity.device)
        return state, step, feats, state.x[0:3], state.x[3:7]

    def fused_fn(self, state: EkfState, step: torch.Tensor, prev: Features,
                 intensity, xyz, conf, draws: StepDraws | None = None,
                 generator: torch.Generator | None = None,
                 host_step: int | None = None):
        """One frame's whole pipeline, eagerly (the body the frame program
        captures): frontend, ``slam_step``, step + 1 → (state, step + 1,
        feats, t, q, stats, record). ``host_step`` decides the periodic
        attitude update."""
        feats = _frame(self._extract_body(intensity[None], xyz[None],
                                          conf[None]), 0)
        state, (stats, rec) = slam_step(
            self.cam, state, feats, prev, step, self.cfg, draws=draws,
            generator=generator,
            image=intensity if self._needs_image else None,
            xyz_img=xyz if self._needs_xyz else None, host_step=host_step)
        return (state, step + 1, feats, state.x[0:3], state.x[3:7], stats,
                rec)

    # -- streaming ----------------------------------------------------------

    def process(self, intensity, xyz, confidence,
                draws: SlamDraws | StepDraws | None = None) -> StepResult:
        """Feed one frame ([H, W], [H, W, 3], [H, W] host arrays: numpy
        or CPU tensors). Returns device pose tensors: reading them
        synchronises, not reading them keeps the card busy. ``draws``
        overrides the generator: a SlamDraws (its ``plane`` and
        ``boot_add``) for the bootstrap frame, a StepDraws for the
        others."""
        with self.timer.stage("dispatch"):
            if self._carry is None:
                img, xyz_d, conf = self._upload(intensity, xyz, confidence)
                state, step, feats, t, q = self.boot_fn(
                    img, xyz_d, conf, draws, self.generator)
                self._carry = (state, step, feats)
                res = StepResult(0, t, q, None)
            else:
                res = self._process_step(intensity, xyz, confidence, draws)
            if self.sync:
                _synchronize(self.device)
        self._advance([res])
        return res

    def _frame_program(self, shapes: tuple, draws):
        state, step, prev = self._carry
        key = shape_key(state, prev, tuple(draws or ())) + shapes
        if key not in self.programs:
            packing = Packing(step_outputs_like(state))
            dev = self.device
            bufs = dict(
                state=empty_like_tree(state), step=torch.empty_like(step),
                prev=empty_like_tree(prev),
                frame=tuple(torch.empty(sh, dtype=torch.float32, device=dev)
                            for sh in shapes),
                draws=None if draws is None else StepDraws(
                    *(empty_like_tree(f) for f in draws)),
                packed=torch.empty(packing.nbytes, dtype=torch.uint8,
                                   device=dev))
            self.programs[key] = (StepProgram(
                "OnlineSlam.process", bufs, dev, 1,
                carry=("state", "step", "prev")), packing)
        return self.programs[key]

    def _frame_body(self, fit: bool, packing: Packing):
        """The frame program's body, per variant: ``fused_fn`` on the
        buffers, with a host index that fits the floor plane (0) or not
        (1) standing in for the step's."""
        def body(b, gens):
            state, step, feats, t, q, stats, rec = self.fused_fn(
                EkfState(*b["state"]), b["step"], Features(*b["prev"]),
                *b["frame"], draws=b["draws"], generator=gens[0],
                host_step=0 if fit else 1)
            load((b["state"], b["prev"]), (state, feats))
            b["step"].copy_(step)
            packing.pack((t, q, stats, rec), b["packed"])

        return body

    def _process_step(self, intensity, xyz, confidence, draws):
        """A frame after the bootstrap: into the frame program's buffers,
        one run, its packed outputs into the next storage row."""
        self._primed()
        shapes = tuple(tuple(np.shape(a)) for a in (intensity, xyz,
                                                    confidence))
        prog, packing = self._frame_program(shapes, draws)
        b = prog.buffers
        load((b["state"], b["step"], b["prev"]), self._carry)
        if draws is not None:
            load(b["draws"], draws)
        self._upload(intensity, xyz, confidence, out=b["frame"])
        every = self.cfg.heading_update_every
        fit = every > 0 and self.step_i % every == 0
        prog.run((fit, _fast_math()), self._frame_body(fit, packing),
                 [self.generator])
        row = self._storage_row(packing.nbytes)
        row.copy_(b["packed"])
        t, q, stats, rec = packing.unpack(row)
        self._records.append(StepRecord(*(x[None] for x in rec)))
        self._carry = (EkfState(*b["state"]), b["step"],
                       Features(*b["prev"]))
        return StepResult(self.step_i, t, q, stats)

    def _storage_row(self, nbytes: int) -> torch.Tensor:
        """The next row of per-step storage (never reused)."""
        if (self._store is None or self._store_used == STORE_ROWS
                or self._store.shape[1] != nbytes):
            self._store = torch.empty((STORE_ROWS, nbytes), dtype=torch.uint8,
                                      device=self.device)
            self._store_used = 0
        self._store_used += 1
        return self._store[self._store_used - 1]

    def process_chunk(self, intensity, xyz, confidence,
                      draws: StepDraws | None = None) -> list[StepResult]:
        """Feed C frames (host arrays with leading axis C) as one
        frontend batch and ``scan_steps``' program (one replay per step).
        Must follow the bootstrap frame, which process() takes.
        ``draws``: stacked StepDraws for the C steps."""
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
        """Restore state, step and generator state from a snapshot, copied
        into the live carry where there is one. The previous frame's
        features are not checkpointed: call prime() with frame step_i − 1
        before the next process()."""
        from pre3_tpu_torch.utils.checkpoint import load_state

        state, self.step_i, gen_state, _ = load_state(path, self.device)
        if gen_state is not None:
            self.generator.set_state(gen_state)
        step = torch.full((), self.step_i, dtype=torch.int32,
                          device=self.device)
        if self._carry is None:
            self._carry = (state, step, None)
            return
        live_state, live_step, _ = self._carry
        load((live_state, live_step), (state, step))
        self._carry = (live_state, live_step, None)

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
