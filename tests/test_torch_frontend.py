"""FAST + patch frontend of the port vs the JAX reference, on rendered frames.

The port's ``extract_features`` takes a leading frame axis; the reference
extracts one frame per call and is vmapped here, as bench.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.frontend import depth_lift as jlift
from pre3_tpu.frontend import fast as jfast
from pre3_tpu.frontend import patches as jpatches
from pre3_tpu.frontend.pipeline import extract_features as jextract
from pre3_tpu_torch.frontend import depth_lift as tlift
from pre3_tpu_torch.frontend import fast as tfast
from pre3_tpu_torch.frontend import patches as tpatches
from pre3_tpu_torch.frontend.pipeline import extract_features as textract
from pre3_tpu_torch.utils.topk import stable_topk

# FAST scores are sums of threshold excesses taken through a cumulative
# sum; XLA and torch accumulate it in another order, so a score may differ
# in its last bits (scores are ≤ ~3, f32 ulp there is 2.4e-7).
SCORE_ATOL = 1e-6


@pytest.fixture(scope="module")
def frames():
    fr, _, _ = render_sequence(n_frames=3, n_points=300, noise=0.004)
    intensity = np.stack([f.intensity for f in fr])
    xyz = np.stack([f.xyz for f in fr])
    conf = np.stack([f.confidence for f in fr])
    return intensity, xyz, conf


@pytest.mark.parametrize("max_features", [128, 256])
def test_extract_features_matches_jax(frames, max_features):
    """uv, valid and xyz are equal; score within SCORE_ATOL; desc within
    1e-5 (the reference samples patches with blend matmuls, the port with
    4-corner gathers: equal values to ~1e-7 before normalization)."""
    intensity, xyz, conf = frames
    ref = jax.vmap(lambda i, x, c: jextract(
        i, x, c, threshold=0.05, max_features=max_features))(
        intensity, xyz, conf)
    got = textract(torch.as_tensor(intensity), torch.as_tensor(xyz),
                   torch.as_tensor(conf), threshold=0.05,
                   max_features=max_features)
    assert got.uv.shape == (3, max_features, 2)
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(ref.uv))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(ref.xyz))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc),
                               atol=1e-5)
    assert got.valid.sum() > 0.5 * got.valid.numel()


@pytest.mark.parametrize("arc", [9, 12])
def test_fast_score_map_and_nonmax(frames, arc):
    img = frames[0][1]
    ref = np.array(jfast.fast_score_map(jnp.asarray(img), 0.05, arc=arc))
    got = tfast.fast_score_map(torch.as_tensor(img), 0.05, arc=arc).numpy()
    np.testing.assert_allclose(got, ref, atol=SCORE_ATOL)
    # non-max suppression is pure comparisons: equal on the same input
    np.testing.assert_array_equal(
        tfast.nonmax_suppress(torch.as_tensor(ref)).numpy(),
        np.asarray(jfast.nonmax_suppress(jnp.asarray(ref))))


def test_detect_batched_equals_per_frame(frames):
    """The frame axis is a plain batch axis: each frame's corners are the
    reference's for that frame."""
    intensity = frames[0]
    got = tfast.detect(torch.as_tensor(intensity), 0.05, max_corners=64)
    for f in range(intensity.shape[0]):
        ref = jfast.detect(jnp.asarray(intensity[f]), 0.05, max_corners=64)
        np.testing.assert_array_equal(got.uv[f].numpy(), np.asarray(ref.uv))
        np.testing.assert_array_equal(got.valid[f].numpy(),
                                      np.asarray(ref.valid))


def test_bilinear_and_patch_descriptors(frames):
    img = frames[0][0]
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(-3, 180, 64), rng.uniform(-3, 148, 64)],
                  -1).astype(np.float32)
    np.testing.assert_allclose(
        tpatches.bilinear_sample(torch.as_tensor(img),
                                 torch.as_tensor(uv)).numpy(),
        np.asarray(jpatches.bilinear_sample(jnp.asarray(img),
                                            jnp.asarray(uv))),
        atol=1e-6)
    for patch in (7, 11):
        np.testing.assert_allclose(
            tpatches.extract_patch_descriptors(
                torch.as_tensor(img), torch.as_tensor(uv), patch=patch).numpy(),
            np.asarray(jpatches.extract_patch_descriptors(
                jnp.asarray(img), jnp.asarray(uv), patch=patch)),
            atol=1e-5)


def test_lift_gates_per_frame(frames):
    """Confidence is gated against each frame's own maximum."""
    _, xyz, conf = frames
    conf = conf.copy()
    conf[1] *= 0.5  # a dimmer frame: its gate halves too
    rng = np.random.default_rng(1)
    uv = np.stack([rng.integers(0, 176, (3, 50)), rng.integers(0, 144, (3, 50))],
                  -1).astype(np.float32)
    valid = rng.uniform(size=(3, 50)) > 0.1
    got = tlift.lift(torch.as_tensor(uv), torch.as_tensor(valid),
                     torch.as_tensor(xyz), torch.as_tensor(conf))
    for f in range(3):
        ref = jlift.lift(jnp.asarray(uv[f]), jnp.asarray(valid[f]),
                         jnp.asarray(xyz[f]), jnp.asarray(conf[f]))
        np.testing.assert_array_equal(got.valid[f].numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_array_equal(got.xyz[f].numpy(), np.asarray(ref.xyz))


@pytest.mark.parametrize("k", [1, 5, 40])
def test_stable_topk_breaks_ties_like_jax(k):
    """Mostly-zero maps and -inf masks: ties go to the lower index."""
    rng = np.random.default_rng(2)
    x = np.where(rng.uniform(size=(4, 64)) > 0.8,
                 rng.integers(1, 4, (4, 64)), 0).astype(np.float32)
    x[3, :10] = -np.inf
    vals, idx = stable_topk(torch.as_tensor(x), k)
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_extract_features_rejects_unbatched_input(frames):
    intensity, xyz, conf = frames
    with pytest.raises(ValueError, match=r"\[F, H, W\]"):
        textract(torch.as_tensor(intensity[0]), torch.as_tensor(xyz[0]),
                 torch.as_tensor(conf[0]))
