"""Multi-process SLAM stage pipeline.

Port of ``pre3_tpu/runtime/stage_pipeline.py``. Two cooperating
mechanisms:

1. **Sharded frontend** (``sharded_extract``): per-frame feature
   extraction is embarrassingly parallel, so each rank of a mesh axis
   extracts its contiguous slice of a frame chunk through the
   frontend's program at the slice's frame count, and the ``Features``
   fields are all-gathered outside it: every rank holds the chunk's
   features, replicated.

2. **Chunked software pipeline** (``run_slam_pipelined``): the EKF
   backend is a strict recursion over frames, so the pipeline overlaps
   stages, not frames: the frontend of chunk c+1 is issued before the
   backend ``scan_steps`` of chunk c. On the card it runs on a side
   stream and the backend waits on its event, so the card interleaves
   the two; the host issues the next chunk's frontend (one replay of
   the frontend's program per chunk) before it replays the current
   chunk's steps (``scan_steps``' step program: one graph replay per
   step). The frontend program's buffers serve every call: chunk c's
   copy out of them precedes chunk c+1's copy in, both on the side
   stream, and each call's features are its own tensors, made on the
   side stream and recorded on the main one. The first chunk captures its program inside the
   loop (one program serves every chunk length); the capture is
   thread-local and waits for the device as it begins, so the side
   stream's frontend finishes first and may allocate freely on it
   (``utils/graphs.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from pre3_tpu_torch.ekf.slam import (
    SlamConfig, SlamDraws, SlamTrajectory, StepDraws, StepRecord, StepStats,
    bootstrap_state, scan_steps,
)
from pre3_tpu_torch.frontend.pipeline import (
    Features, extract_features, extract_features_sift,
)
from pre3_tpu_torch.geometry.camera import Camera
from pre3_tpu_torch.parallel.mesh import Mesh, all_gather, shard_batch


def _extractor(name: str, kwargs: dict | None) -> Callable:
    kw = dict(kwargs or {})
    if name == "fast":
        return partial(extract_features, **kw)
    if name == "sift":
        return partial(extract_features_sift, **kw)
    raise ValueError(f"unknown extractor {name!r}")


def sharded_extract(
    mesh: Mesh,
    intensity: torch.Tensor,  # [C, H, W] — C divisible by the axis size
    xyz: torch.Tensor,  # [C, H, W, 3]
    conf: torch.Tensor,  # [C, H, W]
    extractor: str = "sift",
    extractor_kwargs: dict | None = None,
    axis: str | None = None,
) -> Features:
    """Frame-sharded frontend: each rank extracts its slice of the chunk;
    the features come back replicated (one all-gather per field)."""
    fe = _extractor(extractor, extractor_kwargs)
    local = fe(*(shard_batch(mesh, x, axis) for x in (intensity, xyz, conf)))
    return Features(*(all_gather(mesh, x, axis) for x in local))


def run_slam_pipelined(
    cam: Camera,
    intensity: torch.Tensor,  # [F, H, W]
    xyz: torch.Tensor,  # [F, H, W, 3]
    conf: torch.Tensor,  # [F, H, W]
    mesh: Mesh | None = None,
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    chunk: int = 32,
    extractor: str = "sift",
    extractor_kwargs: dict | None = None,
    draws: SlamDraws | None = None,
    generator: torch.Generator | None = None,
) -> SlamTrajectory:
    """Chunked frontend→backend pipeline over a full sequence.

    Frames are processed in chunks of ``chunk``: the frontend of chunk
    c+1 (sharded over ``mesh`` when the chunk divides its axis) is issued
    before the backend scan of chunk c. ``draws`` has run_slam's layout
    (frame 0's bootstrap with the plane-fit prior from xyz[0], then one
    entry per step), so with the same draws and the same features the
    result is run_slam's; what it leaves None comes from ``generator``."""
    n_frames = intensity.shape[0]
    fe = _extractor(extractor, extractor_kwargs)
    axis_size = 1 if mesh is None else mesh.axis().size
    draws = SlamDraws(steps=StepDraws()) if draws is None else draws
    cuda = intensity.device.type == "cuda"
    side = torch.cuda.Stream(intensity.device) if cuda else None

    def fe_chunk(lo, hi):
        """Features of frames [lo, hi) and the event that marks them
        ready: sharded SPMD extraction when the chunk divides the mesh;
        each rank extracts ragged chunks (frame 0, the tail) itself."""
        if side is None:
            return _fe(lo, hi), None
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            feats = _fe(lo, hi)
            ready = torch.cuda.Event()
            ready.record(side)
        return feats, ready

    def _fe(lo, hi):
        if mesh is not None and (hi - lo) % axis_size == 0:
            return sharded_extract(
                mesh, intensity[lo:hi], xyz[lo:hi], conf[lo:hi],
                extractor=extractor, extractor_kwargs=extractor_kwargs)
        return fe(intensity[lo:hi], xyz[lo:hi], conf[lo:hi])

    def take(pending):
        """The chunk's features, for use on the current stream."""
        feats, ready = pending
        if ready is not None:
            torch.cuda.current_stream().wait_event(ready)
            for x in feats:  # made on the side stream, used on this one
                x.record_stream(torch.cuda.current_stream())
        return feats

    def pick(d, lo, hi):
        return None if d is None else d[lo - 1:hi - 1]

    bounds = [(lo, min(lo + chunk, n_frames))
              for lo in range(1, n_frames, chunk)]

    # frame 0: bootstrap
    feats0 = take(fe_chunk(0, 1))
    first = Features(*(x[0] for x in feats0))
    state = bootstrap_state(
        cam, first, cfg, n_landmarks, xyz_img=xyz[0],
        plane_gumbel=draws.plane, add_gumbel=draws.boot_add,
        generator=generator)
    q0_row = state.x[3:7][None]

    # software pipeline: keep the NEXT chunk's frontend in flight
    pending = fe_chunk(*bounds[0]) if bounds else None
    prev_last = first
    outs = []
    for ci, (lo, hi) in enumerate(bounds):
        feats = take(pending)
        if ci + 1 < len(bounds):
            pending = fe_chunk(*bounds[ci + 1])  # issue ahead
        step_draws = StepDraws(
            vo=pick(draws.steps.vo, lo, hi),
            ransac=pick(draws.steps.ransac, lo, hi),
            add=pick(draws.steps.add, lo, hi))
        state, out = scan_steps(
            cam, state, prev_last, feats,
            torch.arange(lo, hi, dtype=torch.int32, device=intensity.device),
            cfg, draws=step_draws, generator=generator, first_step=lo)
        prev_last = Features(*(x[-1] for x in feats))
        outs.append(out)

    dev = intensity.device
    ts = torch.cat([torch.zeros((1, 3), dtype=q0_row.dtype, device=dev)]
                   + [o[0] for o in outs])
    qs = torch.cat([q0_row] + [o[1] for o in outs])
    stats = StepStats(*(torch.cat(f) for f in zip(*(o[2] for o in outs))))
    records = StepRecord(*(torch.cat(f) for f in zip(*(o[3] for o in outs))))
    return SlamTrajectory(t=ts, q=qs, stats=stats, records=records)
