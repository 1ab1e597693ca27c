"""ATE spread of the port's config #2 slice over its random seeds.

``chip_smoke.py`` runs config #2 (FAST + the warped-patch NCC matcher,
256 corridor frames, K = 256) twice, with ``torch.Generator`` seeds 0
and 1, and holds each ATE to the JAX reference's band. This script runs
the same slice, through the smoke's own helpers, for seeds 0..N-1 and
prints each seed's ATE (no alignment) and mean per-step counts, and the
spread, to set one reading beside the port's own noise.

Run it from the root of a checkout, on a GPU (or ``--device cpu``,
minutes per seed):

    python3 tools/torch_ate_spread.py [--seeds 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from pre3_tpu_torch.ekf.slam import SlamConfig  # noqa: E402
from pre3_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    drift = 0.03 * 0.5 * smoke.N_FRAMES
    images, gt = smoke.render(smoke.N_FRAMES, smoke.N_POINTS,
                              (-1.8, drift + 1.8))
    im = [torch.as_tensor(a, device=dev) for a in images]
    cfg = SlamConfig(**smoke.NCC_CFG)
    ates = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        out = smoke.run_ekf(im, smoke.EKF_LANDMARKS, cfg, xyz_imgs=im[1],
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))
        t = out.t.cpu().numpy()
        ate = float(ate_rmse(t, gt, align=False))
        ates.append(ate)
        s = out.stats
        print(f"seed {seed}: ATE {ate:.4f} m, mean n_ic "
              f"{float(s.n_ic.float().mean()):.2f}, n_li "
              f"{float(s.n_li.float().mean()):.2f}, finite "
              f"{bool(np.isfinite(t).all())}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    a = np.array(ates)
    print(f"ncc ATE over seeds 0..{args.seeds - 1} ({dev}): min "
          f"{a.min():.4f}, max {a.max():.4f}, mean {a.mean():.4f}, std "
          f"{a.std():.4f} m ({', '.join(f'{x:.4f}' for x in a)})", flush=True)


if __name__ == "__main__":
    main()
