"""SR4000 ToF camera frame IO.

Parses the reference's `.dat` frame layout (read_xyz_sr4000.m:10-12,
read_image_sr4000.m:1-29): each frame file is an ASCII/binary matrix of
721 rows × 176 cols of float32 values stacked as

  rows   0..143   z   (depth, meters)
  rows 144..287   x
  rows 288..431   y
  rows 432..575   intensity (raw counts, uint16-ish range)
  rows 576..719   confidence
  row  720        timestamp (milliseconds, first column)

Processing mirrors the reference: 3×3 Gaussian smoothing of the intensity
image, normalization to [0,1] with >65000 outlier clamping
(read_image_sr4000.m:8-23), and confidence gating + SR4000→camera axis flip
[-x,-y,z] applied downstream in the depth lift
(inittialize_depth_my_version.m:74-88).

This is a host-side (numpy) component — frames are small (176×144); the
hot path starts after frames are on device. A Frame is a pytree of arrays.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np

H, W = 144, 176
_ROWS_PER_FRAME = 721


class Frame(NamedTuple):
    """One SR4000 frame, camera-convention xyz (x right, y down, z forward)."""

    intensity: np.ndarray  # [H, W] float32 in [0, 1]
    xyz: np.ndarray  # [H, W, 3] float32, camera frame, NaN where invalid
    confidence: np.ndarray  # [H, W] float32
    timestamp: float  # seconds


def _gaussian3x3(img: np.ndarray) -> np.ndarray:
    """Separable 3×3 Gaussian (σ=0.5 binomial approx), reflect padding —
    mirrors MATLAB fspecial('gaussian') default used on load."""
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    pad = np.pad(img, 1, mode="edge")
    tmp = (
        k[0] * pad[:-2, 1:-1] + k[1] * pad[1:-1, 1:-1] + k[2] * pad[2:, 1:-1]
    )
    pad2 = np.pad(tmp, ((0, 0), (1, 1)), mode="edge")
    return k[0] * pad2[:, :-2] + k[1] * pad2[:, 1:-1] + k[2] * pad2[:, 2:]


def normalize_intensity(raw: np.ndarray) -> np.ndarray:
    """Raw intensity counts → float [0,1] with outlier clamp
    (read_image_sr4000.m: values > 65000 are sensor artifacts)."""
    img = raw.astype(np.float32)
    img = np.where(img > 65000.0, 0.0, img)
    mx = float(img.max())
    if mx > 0:
        img = img / mx
    return img


def parse_dat(raw: np.ndarray, smooth: bool = True) -> Frame:
    """Decode a [721, 176] value matrix into a Frame.

    Applies the SR4000→camera coordinate flip [-x, -y, z]
    (inittialize_depth_my_version.m:85) so downstream code sees a standard
    x-right / y-down / z-forward camera frame.
    """
    assert raw.shape == (_ROWS_PER_FRAME, W), raw.shape
    z = raw[0:H].astype(np.float32)
    x = raw[H : 2 * H].astype(np.float32)
    y = raw[2 * H : 3 * H].astype(np.float32)
    intensity = normalize_intensity(raw[3 * H : 4 * H])
    confidence = raw[4 * H : 5 * H].astype(np.float32)
    ts = float(raw[720, 0]) / 1000.0
    if smooth:
        intensity = _gaussian3x3(intensity)
    xyz = np.stack([-x, -y, z], axis=-1)
    return Frame(intensity=intensity, xyz=xyz, confidence=confidence, timestamp=ts)


def read_frame(path: str, smooth: bool = True) -> Frame:
    """Read one `.dat` frame file (ASCII whitespace-separated floats, the
    format consumed by MATLAB's load() in read_xyz_sr4000.m)."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw.reshape(_ROWS_PER_FRAME, W)
    return parse_dat(raw, smooth=smooth)


_FRAME_RE = re.compile(r"d1_(\d+)\.dat$")


def list_sequence(directory: str) -> list[str]:
    """Enumerate `d1_NNNN.dat` frames in order (data_file_counting.m:1-17)."""
    entries = []
    for name in os.listdir(directory):
        m = _FRAME_RE.search(name)
        if m:
            entries.append((int(m.group(1)), os.path.join(directory, name)))
    entries.sort()
    return [p for _, p in entries]


def depth_valid_mask(
    frame: Frame,
    min_range: float = 0.4,
    confidence_ratio: float = 0.5,
) -> np.ndarray:
    """Depth validity gate (inittialize_depth_my_version.m:74: discard NaN,
    range < 0.4 m, or confidence ≤ 0.5·max)."""
    d = np.linalg.norm(frame.xyz, axis=-1)
    conf_thresh = confidence_ratio * float(frame.confidence.max())
    return (
        np.isfinite(d)
        & (d >= min_range)
        & (frame.confidence > conf_thresh)
    )
