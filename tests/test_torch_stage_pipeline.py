"""The stage pipeline, port vs JAX reference (tests/test_stage_pipeline.py's
cases): the frame-sharded frontend over 2 spawned CPU ranks against the
serial batched extractor, and the chunked frontend→backend pipeline, in
this process (mesh=None) and over 2 ranks, against the reference's
run_slam_pipelined with its draws reproduced from its key and injected.
"""

import jax
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.slam import SlamConfig as JSlamConfig
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu.runtime.stage_pipeline import (
    run_slam_pipelined as jrun_slam_pipelined,
)
from pre3_tpu_torch.ekf.slam import SlamConfig
from pre3_tpu_torch.frontend.pipeline import extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.runtime.stage_pipeline import run_slam_pipelined
from test_torch_parallel import spawn
from test_torch_slam import _run_draws

EK = {"threshold": 0.05, "max_features": 128}
N_FRAMES, K, CHUNK = 9, 32, 4
# t and q: the reference test's bound on the pipeline against run_slam.
POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def seq():
    frames, _, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                   noise=0.004)
    return (np.stack([f.intensity for f in frames]),
            np.nan_to_num(np.stack([f.xyz for f in frames])),
            np.stack([f.confidence for f in frames]))


@pytest.fixture(scope="module")
def draws():
    """The reference pipeline's draws: run_slam's layout (bootstrap with
    the plane fit, then one split per step) from PRNGKey(3)."""
    return _run_draws(jax.random.PRNGKey(3), SlamConfig(match_ratio=1.3),
                      N_FRAMES, with_plane=True, kf=EK["max_features"])


@pytest.fixture(scope="module")
def reference(seq):
    out = jrun_slam_pipelined(
        jcamera(), *seq, jax.random.PRNGKey(3), mesh=None,
        cfg=JSlamConfig(match_ratio=1.3), n_landmarks=K, chunk=CHUNK,
        extractor="fast", extractor_kwargs=EK)
    return jax.tree.map(np.asarray, out)


def _draws_dict(d):
    return {"steps": d.steps._asdict(), "boot_add": d.boot_add,
            "plane": d.plane}


@pytest.fixture(scope="module")
def ranks(seq, draws):
    """Two spawned ranks: the sharded frontend on 8 frames, then the
    pipeline over the 9 with chunks of 4 (frame 0 extracted by each rank,
    both chunks sharded)."""
    im = [torch.as_tensor(a) for a in seq]
    cases = [
        {"name": "extract", "kind": "extract", "mesh": {"axis": "frame"},
         "args": {"intensity": im[0][:8], "xyz": im[1][:8],
                  "conf": im[2][:8], "extractor": "fast",
                  "extractor_kwargs": EK}},
        {"name": "pipeline", "kind": "pipeline", "mesh": {"axis": "frame"},
         "args": {"intensity": im[0], "xyz": im[1], "conf": im[2],
                  "cfg": {"match_ratio": 1.3}, "n_landmarks": K,
                  "chunk": CHUNK, "extractor": "fast",
                  "extractor_kwargs": EK, "draws": _draws_dict(draws)}},
    ]
    return spawn(2, cases)


def test_sharded_extract_matches_serial(seq, ranks):
    """Each rank extracts 4 of the 8 frames; the gathered features equal
    the serial batched extractor's (atol 1e-5, the reference test's)."""
    ref = extract_features(*(torch.as_tensor(a[:8]) for a in seq), **EK)
    got = ranks[0]["outputs"]["extract"]
    for name, r in ref._asdict().items():
        if r.dtype == torch.bool:
            assert torch.equal(got[name], r), name
        else:
            np.testing.assert_allclose(got[name], r, atol=1e-5, err_msg=name)
    assert torch.equal(got["uv"], ranks[1]["outputs"]["extract"]["uv"])


def _check(t, q, n_li, ref):
    np.testing.assert_allclose(t, ref.t, atol=POSE_ATOL)
    np.testing.assert_allclose(q, ref.q, atol=POSE_ATOL)
    np.testing.assert_array_equal(n_li, ref.stats.n_li)


def test_pipelined_without_mesh_matches_jax(seq, draws, reference):
    out = run_slam_pipelined(
        sr4000_camera(), *(torch.as_tensor(a) for a in seq), mesh=None,
        cfg=SlamConfig(match_ratio=1.3), n_landmarks=K, chunk=CHUNK,
        extractor="fast", extractor_kwargs=EK, draws=draws)
    _check(out.t.numpy(), out.q.numpy(), out.stats.n_li.numpy(), reference)
    assert reference.stats.vo_ok.all() and reference.stats.n_li.mean() > 5


def test_pipelined_over_two_ranks_matches_jax(ranks, reference):
    got = ranks[0]["outputs"]["pipeline"]
    _check(got["t"].numpy(), got["q"].numpy(), got["stats.n_li"].numpy(),
           reference)
    comm = ranks[0]["records"]["pipeline"]["comm"]
    assert comm["all_gather/gloo"]["count"] == 2 * 5  # 2 chunks × 5 fields
