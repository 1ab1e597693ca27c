"""The system under test: the calls the windows make into the port
(``pre3_tpu_torch``), built from a configuration file. Nothing here
times or checks anything.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from pre3_tpu_torch.ekf.slam import (
    SlamConfig, bootstrap_state, run_slam, scan_steps,
)
from pre3_tpu_torch.frontend.pipeline import (
    Features, extract_features, extract_features_sift,
)
from pre3_tpu_torch.frontend.sift import FRAME_CHUNK
from pre3_tpu_torch.geometry.camera import sr4000_camera


class States(NamedTuple):
    """The program's states of one sequence run again for the check: the
    bootstrapped state, the state before each step index asked for
    (the state after the last step under the sequence's length), and
    the trajectory on the device."""

    state0: tuple
    before: dict
    t: torch.Tensor  # [F, 3]
    q: torch.Tensor  # [F, 4]


class System:
    """One configuration of the port on one device."""

    def __init__(self, config: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.cam = sr4000_camera()
        self.cfg = SlamConfig(**config["slam"])
        self.k = config["n_landmarks"]
        fe = dict(config["frontend"])
        self.extractor = fe.pop("extractor")
        self.extract = partial(
            extract_features_sift if self.extractor == "sift"
            else extract_features, **fe)
        self.images = config["images_to_slam"]
        self.chunk = FRAME_CHUNK  # frames per frontend replay

    def frontend(self, intensity, xyz, conf) -> Features:
        """``extract_features[_sift]`` over [F, ...] device frames."""
        return self.extract(intensity, xyz, conf)

    def slam(self, feats: Features, gen: torch.Generator, intensity=None,
             xyz=None):
        """``run_slam`` over the sequence's features: (t [F, 3], q [F, 4])
        on the device. ``intensity``/``xyz`` go to the filter where the
        configuration gives it the images."""
        tr = run_slam(self.cam, feats, self.cfg, self.k, generator=gen,
                      images=intensity if self.images else None,
                      xyz_imgs=xyz if self.images else None)
        return tr.t, tr.q

    def states(self, feats: Features, gen: torch.Generator, at,
               intensity=None, xyz=None) -> States:
        """``run_slam``'s work again as its public parts, for the check:
        ``bootstrap_state``, then ``scan_steps`` (the same step program)
        in chunks that start at the step indices ``at``, keeping the
        state before each."""
        n = feats.uv.shape[0]
        first = Features(*(x[0] for x in feats))
        img = intensity if self.images else None
        xyz_imgs = xyz if self.images else None
        state0 = bootstrap_state(
            self.cam, first, self.cfg, self.k,
            xyz_img=None if xyz_imgs is None else xyz_imgs[0],
            image=None if img is None else img[0], generator=gen)
        steps = torch.arange(n, dtype=torch.int32, device=self.device)
        bounds = sorted({1, n, *(s for s in at if 1 < s < n)})
        state, prev, before, ts, qs = state0, first, {}, [], []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            before[lo] = state
            state, (t, q, _, _) = scan_steps(
                self.cam, state, prev, Features(*(x[lo:hi] for x in feats)),
                steps[lo:hi], self.cfg, generator=gen,
                xyz_imgs=None if xyz_imgs is None else xyz_imgs[lo:hi],
                first_step=lo, images=None if img is None else img[lo:hi])
            prev = Features(*(x[hi - 1] for x in feats))
            ts.append(t)
            qs.append(q)
        before[n] = state
        t = torch.cat([torch.zeros((1, 3), dtype=ts[0].dtype,
                                   device=self.device), *ts])
        q = torch.cat([state0.x[3:7][None], *qs])
        return States(state0, before, t, q)
