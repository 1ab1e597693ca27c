"""Synthetic SR4000 corridor sequences with ground truth, in NumPy.

The benchmark's own copy of the port's renderer (``data/synthetic.py``):
a world of textured point landmarks in front of a wall, seen by a camera
on a smooth drifting trajectory through the SR4000 model (176×144,
f=250.577, two-term radial distortion). ``render_sequence`` gives the
same frames as the port's for the same arguments; ``noise_seed`` is the
base of the per-frame sensor-noise seeds (the port's is 1000).

Sequences render in worker processes started with ``subprocess`` that
write their arrays to a pipe (``Renders``): no ``multiprocessing``
lock, so nothing is created under ``/dev/shm``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

H, W = 144, 176
# SR4000 calibration
_F, _CX, _CY = 250.57731, 91.69, 72.27
_K1, _K2 = -0.84656, 0.53701
PATCH = 13


class Scene(NamedTuple):
    points: np.ndarray  # [N, 3] world landmarks
    patterns: np.ndarray  # [N, P, P] per-landmark texture
    wall_z: float
    brightness: np.ndarray  # [N]


class Sequence(NamedTuple):
    intensity: np.ndarray  # [F, H, W] float32
    xyz: np.ndarray  # [F, H, W, 3] float32, NaN where no surface
    confidence: np.ndarray  # [F, H, W] float32
    gt: np.ndarray  # [F, 3] positions in the first camera's frame


def make_scene(n_points: int, seed: int, x_range: tuple[float, float],
               depth_range=(1.2, 3.5), lateral: float = 1.8,
               wall_z: float = 4.0) -> Scene:
    rng = np.random.default_rng(seed)
    z = rng.uniform(*depth_range, n_points)
    x = rng.uniform(*x_range, n_points)
    y = rng.uniform(-lateral * 0.8, lateral * 0.8, n_points)
    points = np.stack([x, y, z], axis=-1).astype(np.float32)
    patterns = rng.uniform(0.35, 1.0, (n_points, PATCH, PATCH)).astype(
        np.float32)
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    pad = np.pad(patterns, ((0, 0), (1, 1), (1, 1)), mode="edge")
    patterns = (k[0] * pad[:, :-2, 1:-1] + k[1] * pad[:, 1:-1, 1:-1]
                + k[2] * pad[:, 2:, 1:-1])
    pad = np.pad(patterns, ((0, 0), (0, 0), (1, 1)), mode="edge")
    patterns = (k[0] * pad[:, :, :-2] + k[1] * pad[:, :, 1:-1]
                + k[2] * pad[:, :, 2:])
    yy, xx = np.mgrid[0:PATCH, 0:PATCH] - PATCH // 2
    gauss = np.exp(-(xx**2 + yy**2) / (2 * 2.6**2)).astype(np.float32)
    patterns = 0.25 + 0.75 * patterns * gauss[None]
    patterns *= gauss[None] > 0.05
    brightness = rng.uniform(0.6, 1.0, n_points).astype(np.float32)
    return Scene(points=points, patterns=patterns, wall_z=wall_z,
                 brightness=brightness)


def _rodrigues(v: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    k = v / angle
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def make_trajectory(n_frames: int, seed: int, step_t: float = 0.03,
                    step_r_deg: float = 1.0):
    """Camera centres [F, 3] and camera-to-world rotations [F, 3, 3]:
    ~3 cm and ~1° per frame, low-passed, drifting in +x."""
    rng = np.random.default_rng(seed)
    dt = rng.normal(scale=step_t, size=(n_frames, 3))
    dr = rng.normal(scale=np.radians(step_r_deg), size=(n_frames, 3))
    kernel = np.ones(min(5, n_frames)) / min(5, n_frames)
    for a in (dt, dr):
        for c in range(3):
            a[:, c] = np.convolve(a[:, c], kernel, mode="same")
    dt[:, 0] += step_t * 0.5
    ts = np.cumsum(dt, axis=0)
    ts -= ts[0]
    rs = np.zeros((n_frames, 3, 3))
    r = np.eye(3)
    for i in range(n_frames):
        r = r @ _rodrigues(dr[i])
        rs[i] = r
    return ts.astype(np.float32), rs.astype(np.float32)


def _distort_px(u, v):
    xu = (u - _CX) / _F
    yu = (v - _CY) / _F
    r2 = xu * xu + yu * yu
    d = 1 + _K1 * r2 + _K2 * r2 * r2
    return _CX + _F * xu * d, _CY + _F * yu * d


@functools.cache
def _rays() -> np.ndarray:
    """Per-pixel unit-z camera rays of the distorted pixel grid."""
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


def render_frame(scene: Scene, t_wc, r_wc, noise: float, seed: int):
    """One frame: (intensity, xyz, confidence)."""
    rays = _rays()
    rng = np.random.default_rng(seed)
    p_cam = (scene.points - t_wc) @ r_wc
    d_w = rays @ r_wc.T
    denom = d_w[..., 2]
    s = (scene.wall_z - t_wc[2]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    hit = s > 0.2
    xyz = rays * np.where(hit, s, np.nan)[..., None]
    intensity = np.full((H, W), 0.08, np.float32)
    confidence = np.where(hit, 0.9, 0.05).astype(np.float32)
    z = p_cam[:, 2]
    vis = z > 0.3
    u, v = _distort_px(_CX + _F * p_cam[:, 0] / np.where(vis, z, 1.0),
                       _CY + _F * p_cam[:, 1] / np.where(vis, z, 1.0))
    half = PATCH // 2
    vis &= ((u > half + 1) & (u < W - half - 2) & (v > half + 1)
            & (v < H - half - 2))
    for i in np.argsort(-z):
        if not vis[i]:
            continue
        cu, cv = int(round(u[i])), int(round(v[i]))
        pat = scene.patterns[i] * scene.brightness[i]
        ys = slice(cv - half, cv + half + 1)
        xs = slice(cu - half, cu + half + 1)
        nearer = ~(xyz[ys, xs, 2] < z[i])  # NaN-safe: draws over NaN
        intensity[ys, xs] = np.where(
            nearer, np.maximum(intensity[ys, xs], pat), intensity[ys, xs])
        xyz[ys, xs] = np.where(nearer[..., None], rays[ys, xs] * z[i],
                               xyz[ys, xs])
        confidence[ys, xs] = np.where(nearer, 1.0, confidence[ys, xs])
    if noise > 0:
        intensity = intensity + rng.normal(scale=noise, size=(H, W)).astype(
            np.float32)
    intensity = np.clip(intensity, 0.0, 1.0).astype(np.float32)
    return intensity, xyz.astype(np.float32), confidence


def render_sequence(n_frames: int, scene_seed: int, traj_seed: int,
                    n_points: int, noise: float,
                    x_range: tuple[float, float],
                    noise_seed: int = 1000) -> Sequence:
    """A sequence and its ground truth, as the port's ``render_sequence``
    renders it (its frame i takes the noise seed ``noise_seed + i``)."""
    scene = make_scene(n_points, scene_seed, x_range)
    ts, rs = make_trajectory(n_frames, traj_seed)
    frames = [render_frame(scene, ts[i], rs[i], noise, noise_seed + i)
              for i in range(n_frames)]
    intensity, xyz, conf = (np.stack(x) for x in zip(*frames))
    gt = (ts - ts[0]) @ rs[0]
    return Sequence(intensity, xyz, conf, gt.astype(np.float32))


class Renders:
    """``render_sequence(**job)`` for every job, each in a worker process,
    ``workers`` at a time, all started at once: a thread per running
    worker reads its arrays from the pipe as they come. ``get(i)`` waits
    for job i."""

    def __init__(self, jobs: list[dict], workers: int):
        self.jobs = jobs
        self.notes: list[str] = []  # what each worker said
        self._procs: dict[int, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._pool = ThreadPoolExecutor(max(1, workers))
        self._futures = [self._pool.submit(self._one, i)
                         for i in range(len(jobs))]

    def _one(self, i: int) -> Sequence:
        root = Path(__file__).resolve().parent.parent
        with self._lock:
            if self._closed:
                raise RuntimeError("renders closed")
            proc = self._procs[i] = subprocess.Popen(
                [sys.executable, "-m", "port_bench.render",
                 json.dumps(self.jobs[i])],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            header = json.loads(proc.stdout.readline() or "null")
            arrays = []
            for shape, dtype in header or []:
                a = np.empty(shape, dtype)
                view, got = memoryview(a).cast("B"), 0
                while got < view.nbytes:
                    n = proc.stdout.readinto(view[got:])
                    if not n:
                        raise EOFError("render worker ended early")
                    got += n
                arrays.append(a)
            err = proc.stderr.read().decode()
            if proc.wait() != 0 or header is None:
                raise RuntimeError(f"render worker failed: {err[-2000:]}")
            self.notes.append(err.strip())
            return Sequence(*arrays)
        finally:
            proc.stdout.close()
            proc.stderr.close()
            proc.wait()

    def get(self, i: int) -> Sequence:
        return self._futures[i].result()

    def all(self) -> list[Sequence]:
        return [self.get(i) for i in range(len(self.jobs))]

    def close(self) -> None:
        """Stop every worker still running and wait for it."""
        with self._lock:
            self._closed = True
            for proc in self._procs.values():
                if proc.poll() is None:
                    proc.kill()
        self._pool.shutdown(wait=True, cancel_futures=True)


def _worker(job: str) -> None:
    import time
    t0 = time.perf_counter()
    seq = render_sequence(**json.loads(job))
    print(f"rendered in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    out = sys.stdout.buffer
    out.write((json.dumps([[a.shape, a.dtype.str] for a in seq]) + "\n")
              .encode())
    for a in seq:
        out.write(np.ascontiguousarray(a).data)
    out.flush()


if __name__ == "__main__":
    _worker(sys.argv[1])
