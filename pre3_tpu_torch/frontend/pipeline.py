"""Frontend pipeline: detect → describe → depth-lift, batched over frames.

Port of ``pre3_tpu/frontend/pipeline.py`` (``extract_features``, FAST +
patches, and ``extract_features_sift``). The reference extracts one
frame per call, jitted, and is vmapped by its callers; here the frame
axis is explicit. Each frontend has a plain body (``fast_features``,
``sift_features``: its ops on any number of frames) and an entry point
that runs the body as a step program (``utils/graphs.py``), the
counterpart of the reference's jitted function: the frames go through it
in chunks of ``sift.FRAME_CHUNK`` (64), one program per chunk's frame
count (a tail chunk has its own; it is never padded, since another batch
shape may pick another convolution algorithm and change bits) and its
config. Per chunk the host copies the chunk's intensity, xyz and
confidence into the program's input buffers (one multi-tensor copy),
replays its graph and copies the features out into the call's own [F,
...] storage (one copy per dtype). No op mixes frames, so a frame's
features do not depend on the chunking. SIFT's fast-math branch
(``PRE3_SIFT_FAST_MATH``, read once per call) is a variant of the same
program. Every frontend program's graphs share one memory pool
(``FRONTEND_POOL``): the pool holds the largest chunk's temporaries
however many frame counts and configs have a program. A body captured
into another program (``OnlineSlam``'s frame) calls the plain body: a
program cannot run inside a capture.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from pre3_tpu_torch.frontend import sift
from pre3_tpu_torch.frontend.depth_lift import lift
from pre3_tpu_torch.frontend.fast import detect
from pre3_tpu_torch.frontend.patches import extract_patch_descriptors
from pre3_tpu_torch.utils import profiling
from pre3_tpu_torch.utils.graphs import (
    StepProgram, keep, load_grouped, program, shape_key,
)


# the graph memory pool of every frontend program (utils/graphs.py)
FRONTEND_POOL = "frontend"


class Features(NamedTuple):
    """Fixed-capacity feature set (masked); leading frame axis optional."""

    uv: torch.Tensor  # [..., K, 2]
    desc: torch.Tensor  # [..., K, D]
    xyz: torch.Tensor  # [..., K, 3] camera-frame 3D (0 where invalid)
    valid: torch.Tensor  # [..., K] bool
    score: torch.Tensor  # [..., K] detector response


def fast_features(
    intensity: torch.Tensor,  # [F, H, W] float
    xyz: torch.Tensor,  # [F, H, W, 3], NaNs allowed
    confidence: torch.Tensor,  # [F, H, W]
    threshold: float = 0.06,
    max_features: int = 256,
    patch: int = 11,
) -> Features:
    """The FAST frontend's body: FAST + patch descriptors + depth lift of
    F frames as one batch of plain ops."""
    corners = detect(intensity, threshold=threshold, max_corners=max_features)
    desc = extract_patch_descriptors(intensity, corners.uv, patch=patch)
    lifted = lift(corners.uv, corners.valid, torch.nan_to_num(xyz), confidence)
    return Features(
        uv=corners.uv, desc=desc, xyz=lifted.xyz, valid=lifted.valid,
        score=corners.score,
    )


def sift_features(
    intensity: torch.Tensor,  # [F, H, W] float
    xyz: torch.Tensor,  # [F, H, W, 3], NaNs allowed
    confidence: torch.Tensor,  # [F, H, W]
    n_octaves: int = 3,
    keypoints_per_octave: int = 96,
    peak_thresh: float = 0.004,
    upright: bool = True,
    fast: bool | None = None,
) -> Features:
    """The SIFT frontend's body: DoG keypoints + 128-D descriptors +
    depth lift of F frames as one batch of plain ops (one chunk of
    ``extract_sift``). ``fast``: the fast-math branch, by default as
    ``PRE3_SIFT_FAST_MATH`` says now."""
    f = sift._extract_chunk(
        intensity, n_octaves, 3, keypoints_per_octave, peak_thresh, upright,
        sift._fast_math() if fast is None else fast)
    lifted = lift(f.uv, f.valid, torch.nan_to_num(xyz), confidence)
    return Features(uv=f.uv, desc=f.desc, xyz=lifted.xyz, valid=lifted.valid,
                    score=f.score)


def extract_features(
    intensity: torch.Tensor,  # [F, H, W] float
    xyz: torch.Tensor,  # [F, H, W, 3], NaNs allowed
    confidence: torch.Tensor,  # [F, H, W]
    threshold: float = 0.06,
    max_features: int = 256,
    patch: int = 11,
) -> Features:
    """FAST + patch descriptors + depth lift for F frames, through the
    program of ``fast_features``; every field of the result has the
    leading frame axis F."""
    _check_frames("extract_features", intensity, xyz, confidence)
    return _chunked("extract_features", (threshold, max_features, patch),
                    None, partial(fast_features, threshold=threshold,
                                  max_features=max_features, patch=patch),
                    intensity, xyz, confidence)


def extract_features_sift(
    intensity: torch.Tensor,  # [F, H, W] float
    xyz: torch.Tensor,  # [F, H, W, 3], NaNs allowed
    confidence: torch.Tensor,  # [F, H, W]
    n_octaves: int = 3,
    keypoints_per_octave: int = 96,
    peak_thresh: float = 0.004,
    upright: bool = True,
) -> Features:
    """SIFT variant of the frontend (the reference's primary extractor):
    DoG keypoints + 128-D descriptors + depth lift for F frames, through
    the program of ``sift_features``, K = n_octaves·keypoints_per_octave
    per frame (288 by default). The branch follows
    ``PRE3_SIFT_FAST_MATH`` at this call."""
    _check_frames("extract_features_sift", intensity, xyz, confidence)
    fast = sift._fast_math()
    return _chunked("extract_features_sift",
                    (n_octaves, keypoints_per_octave, peak_thresh, upright),
                    fast, partial(sift_features, n_octaves=n_octaves,
                                  keypoints_per_octave=keypoints_per_octave,
                                  peak_thresh=peak_thresh, upright=upright,
                                  fast=fast),
                    intensity, xyz, confidence)


def _chunked(name: str, cfg: tuple, variant, body, intensity, xyz,
             confidence) -> Features:
    """``body`` over the frames in chunks of ``sift.FRAME_CHUNK``, each
    through the program of its frame count (see the module docstring):
    the features in the call's own storage, never a program buffer.
    While the tracer is on (``utils/profiling``), the call is a span
    ``frontend`` and a request of its own, each chunk a span
    ``frontend.chunk``; the chunk program's probes bracket its replay."""
    with profiling.span("frontend", request=True):
        n = intensity.shape[0]
        out = None
        for lo in range(0, n, sift.FRAME_CHUNK):
            with profiling.span("frontend.chunk"):
                part = [x[lo:lo + sift.FRAME_CHUNK]
                        for x in (intensity, xyz, confidence)]
                prog = program(
                    (name, cfg, shape_key(part)),
                    lambda: StepProgram(name, dict(inp=[torch.empty_like(x)
                                                        for x in part]),
                                        intensity.device, pool=FRONTEND_POOL))
                load_grouped(prog.buffers["inp"], part)
                prog.run(variant,
                         lambda b, _g: keep(b, "out", body(*b["inp"])))
                res = prog.buffers["out"]
                if out is None:
                    out = Features(*(x.new_empty((n, *x.shape[1:]))
                                     for x in res))
                load_grouped([x[lo:lo + part[0].shape[0]] for x in out],
                             list(res))
        return out


def extract_sequences(extract, intensity: torch.Tensor, xyz: torch.Tensor,
                      confidence: torch.Tensor, **kwargs) -> Features:
    """``extract`` (``extract_features`` or ``extract_features_sift``)
    over S sequences of F frames ([S, F, H, W] ...) as one call over the
    S·F frames (in the frontend's 64-frame chunks);
    every field of the result has the leading axes [S, F]. The
    reference's tools/measure_batch.py maps its frontend over the
    sequences."""
    s, f = intensity.shape[:2]
    out = extract(intensity.flatten(0, 1), xyz.flatten(0, 1),
                  confidence.flatten(0, 1), **kwargs)
    return Features(*(x.unflatten(0, (s, f)) for x in out))


def _check_frames(name, intensity, xyz, confidence) -> None:
    if intensity.dim() != 3 or xyz.shape != (*intensity.shape, 3) or (
        confidence.shape != intensity.shape
    ):
        raise ValueError(
            f"{name} takes intensity [F, H, W], xyz [F, H, W, 3] and "
            f"confidence [F, H, W]; got {tuple(intensity.shape)}, "
            f"{tuple(xyz.shape)}, {tuple(confidence.shape)}"
        )
