"""The comparison that decides ``correct``: what the program produced
against the plain reference (``port_bench/reference``: the SIFT
frontend and the EKF-SLAM step written as plain formulas, in float64,
importing nothing of the program).

From the images the benchmark rendered, the reference recomputes the
frontend's features of every frame of a checked sequence, the
bootstrap from frame 0, and checked steps. A step needs the filter's
state before it, which only the program has: the reference takes it
from the program's own states (``System.states``, the program's
drivers run again outside the window on the same inputs and seeds) and
its own features of the step's two frames. Random draws come from a
``torch.Generator`` seeded as the program's and advanced past the same
draws.

Numbers (compared with a limit where ``port_bench/limits/<cell>.json``
gives one):

* ``feature_miss_share``: the share of valid keypoints, program's and
  reference's together, that find no partner in the other set (same
  frame and octave, position within 0.01 px, score within 0.01%, the
  same lifted point to a millionth; a keypoint whose refinement is
  ill-conditioned moves further under rounding and counts here);
* ``feature_gap``: over the partners, the widest descriptor difference
  or relative score difference;
* ``state_gap_median``: the median over the checked stages (the
  bootstrap and each checked step) of the stage's relative gap
  max|program − reference| ÷ max|reference| of the mean and of the
  covariance, or the share of landmark slots whose activity differs;
* ``steps_off_share``: the share of checked stages whose gap exceeds
  ``STAGE_TOL``;
* ``replay_gap``: the largest difference between the trajectory the
  window returned and the one of the program's run again (exact).

With ``control`` the reference computed in float32 with TF32 on stands
in the program's place: the nearest precision below the
configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import torch

from port_bench.reference import ekf, sift

STAGE_TOL = 1e-4  # a stage whose state gap exceeds this is "off"
FRAME_CHUNK = 64  # frames per pass of the reference frontend
PAIR_PX = 0.01  # a pair's keypoints lie this close (input pixels)
PAIR_SCORE = 1e-4  # and their scores agree to this share


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 inside (``on``), as before
    outside."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def note(what: str) -> None:
    """A step of the check, timed, on standard error."""
    print(f"check {time.perf_counter():12.3f} s: {what}", file=sys.stderr,
          flush=True)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a − b| / max|b| in float64 (0 for two empty tensors)."""
    if b.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def state_gap(prog, ref) -> float:
    """Relative gaps of the mean and the covariance, or the share of
    slots whose activity differs: the widest."""
    return max(rel_gap(prog.x, ref.x), rel_gap(prog.p, ref.p),
               float((prog.active != ref.active).float().mean()))


def feature_numbers(prog, ref, per_octave: int) -> tuple[int, int, float]:
    """(unpaired keypoints, valid keypoints, widest gap of the pairs)
    between two feature sets [F, K, ...] of frames."""
    unpaired, total, gap = 0, 0, 0.0
    n_f, k = ref.valid.shape
    for lo in range(0, k, per_octave):
        sl = slice(lo, lo + per_octave)
        pv, rv = prog.valid[:, sl], ref.valid[:, sl]
        duv = (prog.uv[:, sl, None, :].double()
               - ref.uv[:, None, sl, :]).abs().amax(-1)  # [F, Kp, Kr]
        ps, rs = prog.score[:, sl].double(), ref.score[:, sl]
        dsc = (ps[:, :, None] - rs[:, None, :]).abs() / rs[:, None, :].clamp(
            min=1e-30)
        near = (duv < PAIR_PX) & (dsc < PAIR_SCORE) & pv[:, :, None] & rv[
            :, None, :]
        dist = torch.where(near, duv, torch.inf)
        best = dist.argmin(-1)  # [F, Kp]
        paired = near.any(-1)
        n_pairs = int(paired.sum())
        unpaired += int(pv.sum()) + int(rv.sum()) - 2 * n_pairs
        total += int(pv.sum()) + int(rv.sum())
        if n_pairs:
            fi, pi = torch.nonzero(paired, as_tuple=True)
            ri = best[fi, pi]
            # a pair lifted through different pixels counts as unpaired
            lifted = rel_rows(prog.xyz[:, sl][fi, pi], ref.xyz[:, sl][fi, ri])
            unpaired += 2 * int((lifted > 1e-6).sum())
            dd = (prog.desc[:, sl][fi, pi].double()
                  - ref.desc[:, sl][fi, ri]).abs().amax()
            gap = max(gap, float(dd), float(dsc[fi, pi, ri].amax()))
    return unpaired, total, gap


def rel_rows(a, b) -> torch.Tensor:
    """Per row, max|a − b| ÷ max|b| (rows of zeros: 0 where equal)."""
    d = (a.double() - b).abs().amax(-1)
    return d / b.abs().amax(-1).clamp(min=1e-30)


def summarise(stages: list[float], miss: int, total: int, fgap: float,
              replay: float | None = None) -> dict:
    """The numbers the limits hold, from the check's readings (and the
    widest stage and the count of stages, for the record)."""
    out = dict(
        feature_miss_share=miss / max(total, 1), feature_gap=fgap,
        state_gap_median=statistics.median(stages),
        steps_off_share=sum(g > STAGE_TOL for g in stages) / len(stages),
        state_gap_max=max(stages), stages=len(stages))
    if replay is not None:
        out["replay_gap"] = replay
    return out


class Reference:
    """The plain reference of one configuration (its JSON dict) on one
    device: float64, or with ``control`` float32 with TF32 on."""

    def __init__(self, config: dict, device, control: bool = False):
        self.device = torch.device(device)
        self.control = control
        self.dtype = torch.float32 if control else torch.float64
        self.settings = ekf.Settings.of(config["slam"])
        self.k = config["n_landmarks"]
        fe = dict(config["frontend"])
        if fe.pop("extractor") != "sift" or not fe.pop("upright", True):
            raise ValueError("the reference defines the upright SIFT "
                             "frontend only")
        self.frontend = fe
        self.per_octave = fe["keypoints_per_octave"]

    def features(self, intensity, xyz, conf) -> sift.Features:
        """The frontend over [F, ...] frames, ``FRAME_CHUNK`` at a time."""
        parts = []
        with tf32(self.control):
            for lo in range(0, intensity.shape[0], FRAME_CHUNK):
                hi = lo + FRAME_CHUNK
                parts.append(sift.sift_features(
                    intensity[lo:hi], xyz[lo:hi], conf[lo:hi],
                    dtype=self.dtype, **self.frontend))
        return sift.Features(*(torch.cat(x) for x in zip(*parts)))

    def bootstrap(self, feats0) -> ekf.State:
        with tf32(self.control):
            return ekf.bootstrap(feats0, self.k, self.settings, self.dtype)

    def generator(self, seed: int, steps_before: int,
                  n_feats: int) -> torch.Generator:
        """A generator seeded as the program's, past the draws of the
        bootstrap (none) and of ``steps_before`` steps."""
        gen = torch.Generator(self.device).manual_seed(seed)
        for _ in range(steps_before):
            ekf.draw(self.settings, n_feats, self.k, gen, self.device)
        return gen

    def step(self, state, prev, cur, index: int,
             gen: torch.Generator) -> ekf.State:
        """Step ``index`` from ``state`` (the program's, or the
        reference's own) and the features of its two frames."""
        with tf32(self.control):
            return ekf.step(ekf.as_state(state, self.dtype), prev, cur, index,
                            self.settings, gen)


def clone_states(run):
    """A copy of the program's states that outlives its programs."""
    cp = lambda st: type(st)(*(x.clone() for x in st))  # noqa: E731
    return type(run)(cp(run.state0), {i: cp(s) for i, s in run.before.items()},
                     run.t.clone(), run.q.clone())


def free_program(device) -> None:
    """Drop the program's captured graphs and their memory, so that the
    reference runs on a card the program no longer holds."""
    from pre3_tpu_torch.utils import graphs

    graphs.clear()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def frame(feats, i: int):
    return type(feats)(*(x[i] for x in feats))


def program_features(feats) -> sift.Features:
    """The program's features in the reference's field order."""
    return sift.Features(uv=feats.uv, desc=feats.desc, xyz=feats.xyz,
                         valid=feats.valid, score=feats.score)
