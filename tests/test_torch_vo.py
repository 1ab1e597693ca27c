"""VO of the port vs the JAX reference: matching, RANSAC and frame pairs.

JAX's threefry draws cannot be reproduced in torch, so the reference's own
Gumbel noise is computed here and injected into the port. Features come
from the reference's frontend through ``utils.interop``, so the VO is
checked apart from the frontend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.frontend.pipeline import extract_features as jextract
from pre3_tpu.ops.matching import match_descriptors as jmatch
from pre3_tpu.vo.dead_reckoning import run_sequence as jrun, vo_pair as jvo_pair
from pre3_tpu.vo.ransac import ransac_rigid as jransac
from pre3_tpu_torch.ops.matching import match_descriptors as tmatch
from pre3_tpu_torch.ops.matching import match_descriptors_auto as tmatch_auto
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from pre3_tpu_torch.vo.dead_reckoning import run_sequence as trun
from pre3_tpu_torch.vo.dead_reckoning import vo_pair as tvo_pair
from pre3_tpu_torch.vo.ransac import ransac_rigid as transac

K, BATCH = 128, 256
# Poses come out of a weighted Kabsch refit over ~100 inliers: the two
# packages differ by reduction order only, ~1e-6 (seen ≤ 1.2e-6 over 7
# chained pairs). 1e-5 leaves room and still catches any wrong branch.
POSE_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_feats():
    """Reference features of 4 rendered frames, as numpy."""
    fr, _, _ = render_sequence(n_frames=4, n_points=300, noise=0.004)
    stack = [np.stack([getattr(f, a) for f in fr])
             for a in ("intensity", "xyz", "confidence")]
    feats = jax.vmap(lambda i, x, c: jextract(
        i, x, c, threshold=0.05, max_features=K))(*stack)
    return jax.tree.map(np.array, feats)  # writable copies


def _frame(feats, i):
    return type(feats)(*(x[i] for x in feats))


def _gumbel(key, shape):
    return np.array(jax.random.gumbel(key, shape))


@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_matches_jax(jax_feats, mutual):
    """index and accepted equal; dist2 within 1e-5 (one f32 matmul of
    unit-norm descriptors, reduced in another order)."""
    f1, f2 = _frame(jax_feats, 0), _frame(jax_feats, 1)
    ref = jmatch(jnp.asarray(f1.desc), jnp.asarray(f2.desc),
                 jnp.asarray(f1.valid), jnp.asarray(f2.valid), ratio=1.3,
                 mutual=mutual)
    got = tmatch(torch.as_tensor(f1.desc), torch.as_tensor(f2.desc),
                 torch.as_tensor(f1.valid), torch.as_tensor(f2.valid),
                 ratio=1.3, mutual=mutual)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(ref.accepted))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_allclose(got.dist2.numpy(), np.asarray(ref.dist2),
                               atol=1e-5)
    np.testing.assert_allclose(got.dist2_second.numpy(),
                               np.asarray(ref.dist2_second), atol=1e-5)
    assert got.accepted.sum() > 20


def test_match_pair_mask_and_duplicate_tie():
    """pair_mask restricts candidates; a duplicated column makes
    second == best, so the ratio test rejects the row."""
    rng = np.random.default_rng(3)
    d1 = rng.normal(size=(20, 16)).astype(np.float32)
    d2 = rng.normal(size=(30, 16)).astype(np.float32)
    d2[5] = d1[2]
    d2[6] = d1[2]
    d2[7] = d1[4]
    mask = rng.uniform(size=(20, 30)) > 0.3
    mask[:, 5:8] = True
    for pm in (None, mask):
        ref = jmatch(jnp.asarray(d1), jnp.asarray(d2), ratio=1.5,
                     pair_mask=None if pm is None else jnp.asarray(pm))
        got = tmatch(torch.as_tensor(d1), torch.as_tensor(d2), ratio=1.5,
                     pair_mask=None if pm is None else torch.as_tensor(pm))
        np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
        np.testing.assert_array_equal(got.accepted.numpy(),
                                      np.asarray(ref.accepted))
        assert not bool(got.accepted[2]) and bool(got.accepted[4])


def test_match_auto_on_cpu_is_the_plain_path():
    """At any size a CPU tensor takes the plain path (as the reference
    does off the TPU); only CUDA tensors launch K2."""
    rng = np.random.default_rng(4)
    d1 = torch.as_tensor(rng.normal(size=(2048, 4)).astype(np.float32))
    d2 = torch.as_tensor(rng.normal(size=(2048, 4)).astype(np.float32))
    got = tmatch_auto(d1, d2)
    ref = tmatch(d1, d2)
    assert torch.equal(got.index, ref.index)


def _matched(jax_feats, i):
    f1, f2 = _frame(jax_feats, i), _frame(jax_feats, i + 1)
    m = jmatch(jnp.asarray(f1.desc), jnp.asarray(f2.desc),
               jnp.asarray(f1.valid), jnp.asarray(f2.valid), ratio=1.3)
    idx = np.asarray(m.index)
    valid = np.asarray(m.accepted) & f1.valid & f2.valid[idx]
    return f1.xyz, f2.xyz[idx], valid


@pytest.mark.parametrize("seed,range_weighted", [(0, False), (1, False),
                                                 (2, True)])
def test_ransac_rigid_with_injected_draws(jax_feats, seed, range_weighted):
    """Same Gumbel noise ⇒ same minimal samples, same winner, same inlier
    set; R and t within POSE_ATOL."""
    p1, p2, valid = _matched(jax_feats, seed % 3)
    key = jax.random.PRNGKey(seed)
    ref = jransac(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                  batch=BATCH, range_weighted_refit=range_weighted)
    got = transac(torch.as_tensor(p1), torch.as_tensor(p2),
                  torch.as_tensor(valid), batch=BATCH,
                  range_weighted_refit=range_weighted,
                  gumbel=torch.as_tensor(_gumbel(key, (BATCH, K))))
    assert bool(got.ok) and bool(ref.ok)
    assert int(got.best_support) == int(ref.best_support)
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.r.numpy(), np.asarray(ref.r),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse),
                               atol=1e-6)


def test_ransac_rigid_noise_sources(jax_feats):
    """A generator draws the noise when none is given; neither is an
    error; a mis-shaped draw is an error."""
    p1, p2, valid = (torch.as_tensor(a) for a in _matched(jax_feats, 0))
    res = transac(p1, p2, valid, batch=BATCH,
                  generator=torch.Generator().manual_seed(0))
    assert bool(res.ok) and int(res.n_inliers) > 50
    with pytest.raises(ValueError, match="gumbel noise or a generator"):
        transac(p1, p2, valid, batch=BATCH)
    with pytest.raises(ValueError, match="gumbel must have shape"):
        transac(p1, p2, valid, batch=BATCH, gumbel=torch.zeros(BATCH, K + 1))


def test_vo_pair_matches_jax(jax_feats):
    key = jax.random.PRNGKey(5)
    f1, f2 = _frame(jax_feats, 1), _frame(jax_feats, 2)
    ref = jvo_pair(jax.tree.map(jnp.asarray, f1),
                   jax.tree.map(jnp.asarray, f2), key, batch=BATCH)
    got = tvo_pair(to_torch(f1, device="cpu"), to_torch(f2, device="cpu"),
                   gumbel=torch.as_tensor(_gumbel(key, (BATCH, K))),
                   batch=BATCH)
    ref, got = jax.tree.map(np.asarray, ref), to_numpy(got)
    assert got.ok and ref.ok
    assert got.n_inliers == ref.n_inliers and got.n_matches == ref.n_matches
    np.testing.assert_allclose(got.delta.t, ref.delta.t, atol=POSE_ATOL)
    np.testing.assert_allclose(got.delta.q, ref.delta.q, atol=POSE_ATOL)
    np.testing.assert_array_equal(got.cov, ref.cov)


def test_failure_keeps_previous_pose(jax_feats):
    """All features of frame 1 invalid → pairs 0-1 and 1-2 fail, identity
    motion, ok=False (tests/test_dead_reckoning.py:64), as in the
    reference run on the same draws."""
    feats = jax_feats._replace(valid=jax_feats.valid.copy())
    feats.valid[1] = False
    key = jax.random.PRNGKey(2)
    keys = jax.random.split(key, 3)
    gumbel = np.stack([_gumbel(k, (BATCH, K)) for k in keys])
    ref = jax.tree.map(np.asarray, jrun(jax.tree.map(jnp.asarray, feats),
                                        key, batch=BATCH))
    got = to_numpy(trun(to_torch(feats, device="cpu"),
                        gumbel=torch.as_tensor(gumbel),
                        batch=BATCH))
    np.testing.assert_array_equal(got.ok, ref.ok)
    assert not got.ok[1] and not got.ok[2] and got.ok[3]
    np.testing.assert_array_equal(got.t[1], got.t[0])
    np.testing.assert_allclose(got.t, ref.t, atol=POSE_ATOL)
    np.testing.assert_array_equal(got.n_inliers, ref.n_inliers)
