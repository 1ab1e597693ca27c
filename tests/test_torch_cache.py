"""Disk caches and the offline keyframe pass, port vs JAX reference:
utils/cache.py's FeatureCache and VoCache read what either package wrote
(same directories, file names and npz fields), find_keyframes_vo(vo_cache=)
with the reference's draws injected, and export_keyframe_dataset's files.
Mirrors tests/test_cache_keyframes.py.

Tolerances: cached arrays round-trip exactly. The keyframe pass keeps
the reference's indices and VO-call count exactly and its increments
within POSE_ATOL = 1e-5 (f32 RANSAC refits in another reduction order,
as tests/test_torch_backend.py holds them).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.backend import keyframes as jkeyframes
from pre3_tpu.frontend.pipeline import Features as JFeatures
from pre3_tpu.geometry.se3 import Pose as JPose
from pre3_tpu.utils import cache as jcache
from pre3_tpu.vo.dead_reckoning import VoStep as JVoStep
from pre3_tpu_torch.backend import keyframes
from pre3_tpu_torch.data.export import export_dat_sequence
from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.frontend.pipeline import Features, extract_features
from pre3_tpu_torch.utils import cache
from pre3_tpu_torch.utils.interop import to_numpy
from pre3_tpu_torch.vo.dead_reckoning import vo_pair

N_FRAMES, KF, BATCH = 6, 96, 256
POSE_ATOL = 1e-5


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """Six frames at 0.035 m per frame (tests/test_cache_keyframes.py's
    motion), their FAST features as numpy, and their .dat export."""
    frames, _, _ = render_sequence(n_frames=N_FRAMES, n_points=300,
                                   noise=0.003, step_t=0.035)
    feats = to_numpy(extract_features(
        *(torch.as_tensor(np.nan_to_num(np.stack([getattr(f, a)
                                                  for f in frames])))
          for a in ("intensity", "xyz", "confidence")),
        threshold=0.05, max_features=KF))
    data = tmp_path_factory.mktemp("seq") / "data"
    export_dat_sequence(frames, str(data))
    return feats, str(data)


def _reference_draws(key, n: int) -> np.ndarray:
    """The gumbel noise the reference's find_keyframes_vo draws per
    candidate: one split of the key each."""
    subs = []
    for _ in range(n - 1):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(jax.random.gumbel(sub, (BATCH, KF))))
    return np.stack(subs)


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_feature_cache_round_trip(tmp_path, seq, writer):
    """A FeatureCache entry written by either package reads in both,
    unchanged; the second get of a key is a disk hit."""
    feats, _ = seq
    f0 = Features(*(x[0] for x in feats))
    calls = []
    if writer == "reference":
        jcache.FeatureCache(str(tmp_path)).get(
            0, lambda: (calls.append(1), JFeatures(
                *(jnp.asarray(x) for x in f0)))[1])
    else:
        cache.FeatureCache(str(tmp_path), device="cpu").get(
            0, lambda: (calls.append(1), Features(
                *(torch.as_tensor(x) for x in f0)))[1])
    assert os.path.exists(tmp_path / "FeatureExtractionMatching"
                          / "features_0000.npz")
    fail = lambda: pytest.fail("cache miss")  # noqa: E731
    got = cache.FeatureCache(str(tmp_path), device="cpu").get(0, fail)
    ref = jcache.FeatureCache(str(tmp_path)).get(0, fail)
    assert isinstance(got.uv, torch.Tensor) and got.valid.dtype == torch.bool
    _equal(to_numpy(got), f0)
    _equal(ref, f0)
    assert len(calls) == 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_vo_cache_round_trip(tmp_path, seq, writer):
    """A VoCache entry (vo_<pre>_<cur>.npz: t, q, ok, n_inliers,
    n_matches, cov) written by either package reads in both."""
    feats, _ = seq
    step = vo_pair(*(Features(*(torch.as_tensor(x[i]) for x in feats))
                     for i in (0, 2)),
                   gumbel=torch.as_tensor(_reference_draws(
                       jax.random.PRNGKey(0), 2)[0]), batch=BATCH,
                   with_covariance=True)
    host = to_numpy(step)
    if writer == "reference":
        jcache.VoCache(str(tmp_path)).get(0, 2, lambda: JVoStep(
            delta=JPose(*(jnp.asarray(x) for x in host.delta)),
            **{k: jnp.asarray(getattr(host, k))
               for k in ("ok", "n_inliers", "n_matches", "cov")}))
    else:
        cache.VoCache(str(tmp_path), device="cpu").get(0, 2, lambda: step)
    assert os.path.exists(tmp_path / "RANSAC_pose_shift" / "vo_0_2.npz")
    fail = lambda: pytest.fail("cache miss")  # noqa: E731
    got = cache.VoCache(str(tmp_path), device="cpu").get(0, 2, fail)
    ref = jcache.VoCache(str(tmp_path)).get(0, 2, fail)
    for a in (to_numpy(got), ref):
        _equal(a.delta, host.delta)
        _equal([a.ok, a.n_inliers, a.n_matches, a.cov],
               [host.ok, host.n_inliers, host.n_matches, host.cov])
    assert bool(host.ok) and np.abs(host.cov).sum() > 0


def test_offline_keyframes_with_cache_match_jax(tmp_path, seq, monkeypatch):
    """find_keyframes_vo(vo_cache=) over 6 frames, the reference's draws
    injected: the reference's indices, VO-call count and increments; a
    cache file per call; a warm pass calls vo_pair 0 times and repeats
    the cold pass exactly; the reference reads the port's cache and
    returns its own keyframes."""
    feats, _ = seq
    key = jax.random.PRNGKey(0)
    ref = jkeyframes.find_keyframes_vo(
        jax.tree.map(jnp.asarray, JFeatures(*feats)), key,
        vo_cache=jcache.VoCache(str(tmp_path / "ref")), batch=BATCH)
    gumbel = torch.as_tensor(_reference_draws(key, N_FRAMES))
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return vo_pair(*args, **kw)

    monkeypatch.setattr(keyframes, "vo_pair", counting)
    tfeats = Features(*(torch.as_tensor(x) for x in feats))
    vc = cache.VoCache(str(tmp_path / "port"), device="cpu")
    got = keyframes.find_keyframes_vo(tfeats, vo_cache=vc, batch=BATCH,
                                      gumbel=gumbel)
    assert len(ref.indices) >= 2 and ref.indices[0] == 0
    np.testing.assert_array_equal(got.indices, ref.indices)
    assert got.n_vo_calls == ref.n_vo_calls == len(calls) == N_FRAMES - 1
    np.testing.assert_allclose(got.delta_t, ref.delta_t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.delta_q, ref.delta_q, atol=POSE_ATOL)
    assert len(os.listdir(vc.dir)) == got.n_vo_calls
    assert sorted(os.listdir(vc.dir)) == sorted(os.listdir(
        tmp_path / "ref" / "RANSAC_pose_shift"))

    calls.clear()
    warm = keyframes.find_keyframes_vo(
        tfeats, vo_cache=cache.VoCache(str(tmp_path / "port"), device="cpu"),
        batch=BATCH, gumbel=gumbel)
    assert not calls
    for a, b in zip(warm, got):
        np.testing.assert_array_equal(a, b)
    from_port = jkeyframes.find_keyframes_vo(
        jax.tree.map(jnp.asarray, JFeatures(*feats)), key,
        vo_cache=jcache.VoCache(str(tmp_path / "port")), batch=BATCH)
    np.testing.assert_array_equal(from_port.indices, got.indices)


def test_partly_cached_pass_draws_as_uncached(tmp_path, seq):
    """With a generator, a pass whose first pairs come from the cache
    draws for them all the same: its computed pairs get the draws an
    uncached pass gives them, so the result equals the uncached one."""
    feats, _ = seq
    tfeats = Features(*(torch.as_tensor(x) for x in feats))
    run = lambda vc: keyframes.find_keyframes_vo(  # noqa: E731
        tfeats, vo_cache=vc, batch=BATCH,
        generator=torch.Generator().manual_seed(5))
    cold = run(None)
    vc = cache.VoCache(str(tmp_path), device="cpu")
    first = sorted(os.listdir(tmp_path / "RANSAC_pose_shift"))
    assert not first
    run(vc)
    files = sorted(os.listdir(vc.dir))
    for name in files[2:]:
        os.remove(os.path.join(vc.dir, name))
    partly = run(cache.VoCache(str(tmp_path), device="cpu"))
    for a, b in zip(partly, cold):
        np.testing.assert_array_equal(a, b)


def test_export_keyframe_dataset_matches_jax(tmp_path, seq):
    """The KeyFrames/ mirror: renumbered .dat copies, per-keyframe
    features npz and manifest.json — the reference's file names, bytes
    and keys."""
    feats, data = seq
    kf = jkeyframes.OfflineKeyframes(
        indices=np.array([0, 2, 5]), delta_t=np.zeros((3, 3), np.float32),
        delta_q=np.tile(np.float32([1, 0, 0, 0]), (3, 1)), n_vo_calls=5)
    ref = jkeyframes.export_keyframe_dataset(
        kf.indices, str(tmp_path / "ref"), src_dir=data,
        feats=jax.tree.map(jnp.asarray, JFeatures(*feats)), deltas=kf)
    got = keyframes.export_keyframe_dataset(
        kf.indices, str(tmp_path / "port"), src_dir=data,
        feats=Features(*(torch.as_tensor(x) for x in feats)),
        deltas=keyframes.OfflineKeyframes(*kf))
    names = sorted(os.listdir(got))
    assert names == sorted(os.listdir(ref)) == [
        "d1_0001.dat", "d1_0002.dat", "d1_0003.dat", "features_0001.npz",
        "features_0002.npz", "features_0003.npz", "manifest.json"]
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(got, name)) as a, np.load(
                    os.path.join(ref, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
        else:
            assert (open(os.path.join(got, name), "rb").read()
                    == open(os.path.join(ref, name), "rb").read()), name
    with open(os.path.join(got, "manifest.json")) as f:
        assert json.load(f)["original_indices"] == [0, 2, 5]
