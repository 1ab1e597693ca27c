"""Write frames back into the reference's on-disk `.dat` layout.

The inverse of data/sr4000.py::parse_dat: a [721, 176] matrix of
whitespace-separated floats with rows z / x / y / intensity / confidence
stacked per read_xyz_sr4000.m:10-12 and the timestamp (ms) in row 721
(takeImage.m:27-30). This lets the synthetic renderer produce a
reference-layout dataset directory, so the WHOLE reference operating mode
— directory of `d1_NNNN.dat` files → loader → SLAM → keyframes → BA — can
run and be tested end-to-end without SR4000 hardware.

Camera-frame xyz is flipped back to sensor convention ([-x, -y, z] undone,
inittialize_depth_my_version.m:85); [0, 1] intensity is expanded to raw
counts (the loader re-normalizes by the per-frame max,
read_image_sr4000.m:8-23).
"""

from __future__ import annotations

import os

import numpy as np

from pre3_tpu_torch.data.sr4000 import H, W, Frame

_INTENSITY_COUNTS = 50_000.0  # raw-count scale for [0, 1] intensities


def frame_to_raw(frame: Frame) -> np.ndarray:
    """Frame → the [721, 176] reference value matrix."""
    xyz = np.asarray(frame.xyz, np.float64)
    z = xyz[..., 2]
    x = -xyz[..., 0]  # undo the camera-convention flip
    y = -xyz[..., 1]
    inten = np.asarray(frame.intensity, np.float64) * _INTENSITY_COUNTS
    conf = np.asarray(frame.confidence, np.float64)
    ts = np.zeros((1, W))
    ts[0, 0] = float(frame.timestamp) * 1000.0  # seconds → ms
    raw = np.concatenate([z, x, y, inten, conf, ts], axis=0)
    assert raw.shape == (721, W), raw.shape
    return raw


def write_frame(path: str, frame: Frame) -> None:
    np.savetxt(path, frame_to_raw(frame), fmt="%.6f")


def export_dat_sequence(frames, out_dir: str, dt: float = 0.1) -> list[str]:
    """Write a sequence as `d1_NNNN.dat` (1-based, data_file_counting.m
    numbering). Frames lacking timestamps get k·dt. Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, fr in enumerate(frames):
        ts = getattr(fr, "timestamp", None)
        f = Frame(
            intensity=np.asarray(fr.intensity, np.float32),
            xyz=np.asarray(fr.xyz, np.float32),
            confidence=np.asarray(fr.confidence, np.float32),
            timestamp=float(ts) if ts is not None else i * dt,
        )
        p = os.path.join(out_dir, f"d1_{i + 1:04d}.dat")
        write_frame(p, f)
        paths.append(p)
    return paths
