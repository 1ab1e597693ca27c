"""SIFT frontend of the port vs the JAX reference (its exact branch).

The discrete stages (extrema, refinement, descriptors) are fed the
reference's own intermediates — its DoG, its gradient polar stacks, its
keypoints — so that the convolutions' summation order stays out of those
tests. The whole extractor is then compared on rendered frames, with
keypoints matched as sets: a DoG that differs by 1–2 ulp moves a refined
keypoint by up to ~4e-4 px, and can swap which of two near-equal
responses fills the last top-K slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.frontend import scalespace as jss
from pre3_tpu.frontend import sift as jsift
from pre3_tpu.frontend.pipeline import extract_features_sift as jextract
from pre3_tpu_torch.frontend import scalespace as tss
from pre3_tpu_torch.frontend import sift as tsift
from pre3_tpu_torch.frontend.pipeline import extract_features_sift as textract

S_LEVELS = 3
SIGMA0 = 1.6 * 2.0 ** (1.0 / S_LEVELS)
KPO = 96  # keypoints per octave, extract_features_sift's default
# Blur and pyramid: the same taps summed in another order by another
# convolution (f32, values ≤ 1): seen ≤ 2.4e-7.
PYR_ATOL = 1e-6
# Whole extractor on rendered frames: share of the reference's valid
# keypoints found again (uv within 1e-3 px), and descriptor error on them.
# Upright descriptors come from a triangle-filtered dense stack and move
# ≤ 3e-5 with the ~4e-4 px keypoint shift. Rotated ones also follow the
# orientation, which the histogram's parabolic peak refinement moves by
# up to ~3e-4 rad from the same shift; seen ≤ 7.1e-4.
MIN_MATCHED = 0.98
DESC_ATOL = {True: 1e-4, False: 2e-3}


@pytest.fixture(autouse=True)
def _exact_branch(monkeypatch):
    """The reference's CPU branch: exact top-k and f32 matmuls."""
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "0")


@pytest.fixture(scope="module")
def frames():
    fr, _, _ = render_sequence(n_frames=2, n_points=300, noise=0.004)
    return [np.stack([getattr(f, a) for f in fr]).astype(np.float32)
            for a in ("intensity", "xyz", "confidence")]


@pytest.fixture(scope="module")
def ref_octaves(frames):
    """The reference's pyramid, detections and gradient stacks of frame
    0, per octave (numpy)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRE3_SIFT_FAST_MATH", "0")
        octs = jax.jit(lambda im: [
            (o.gss, o.dog) for o in jss.build_pyramid(
                im, n_octaves=3, s_levels=S_LEVELS, sigma0=SIGMA0)])(
            jnp.asarray(frames[0][0]))
        out = []
        for o, (gss, dog) in enumerate(octs):
            oct_ = jss.Octave(gss=gss, dog=dog, sigmas=(), downsample=2**o)
            det = jax.jit(lambda d, g: jsift._detect_octave(
                jss.Octave(g, d, (), 1), 0.004, KPO, S_LEVELS, SIGMA0))(
                dog, gss)
            mag, ang = jax.vmap(jss.gradient_polar)(oct_.gss)
            out.append(jax.tree.map(np.asarray, dict(
                gss=gss, dog=dog, det=det, mag=mag, ang=ang)))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("sigma", [0.3, 1.0, 1.2263, 2.5, 4.0])
def test_gaussian_kernel_taps_equal(sigma):
    np.testing.assert_array_equal(tss.gaussian_kernel(sigma),
                                  jss.gaussian_kernel(sigma))


def test_blur_and_pyramid(frames, ref_octaves):
    """gaussian_blur on two frames at once and build_pyramid (all
    levels, both stacks) within PYR_ATOL of the reference."""
    img = frames[0]
    for sigma in (0.0, 1.2, 3.1):
        ref = np.stack([np.asarray(jss.gaussian_blur(jnp.asarray(i), sigma))
                        for i in img])
        got = tss.gaussian_blur(_t(img), sigma).numpy()
        np.testing.assert_allclose(got, ref, atol=PYR_ATOL, rtol=0)
    octs = tss.build_pyramid(_t(img), n_octaves=3, s_levels=S_LEVELS,
                             sigma0=SIGMA0)
    for o, (got, ref) in enumerate(zip(octs, ref_octaves)):
        assert got.downsample == 2**o and len(got.sigmas) == S_LEVELS + 3
        np.testing.assert_allclose(got.gss[0].numpy(), ref["gss"],
                                   atol=PYR_ATOL, rtol=0)
        np.testing.assert_allclose(got.dog[0].numpy(), ref["dog"],
                                   atol=PYR_ATOL, rtol=0)


def test_gradient_polar(ref_octaves):
    """Magnitude and angle of every level of octave 0 (wrap-around at
    the edges included): the same differences, then sqrt and atan2, which
    differ by libm ulps."""
    gss = ref_octaves[0]["gss"]
    mag, ang = tss.gradient_polar(_t(gss))
    np.testing.assert_allclose(mag.numpy(), ref_octaves[0]["mag"],
                               atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(ang.numpy(), ref_octaves[0]["ang"],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_extrema_and_refine_fed_reference_dog(ref_octaves, octave):
    """The 26-neighbour extrema mask and the edge mask exactly equal; the
    subpixel offsets and refined values within 1e-5 where they are finite
    and the step is small (elsewhere the 3×3 system is near singular and
    the caller rejects the pixel)."""
    dog = ref_octaves[octave]["dog"]
    ref_ext = np.asarray(jsift._local_extrema(jnp.asarray(dog), 0.004))
    ref_off, ref_edge, ref_val = jax.tree.map(
        np.asarray, jsift._refine(jnp.asarray(dog)))
    got_ext = tsift._local_extrema(_t(dog)[None], 0.004)[0].numpy()
    got_off, got_edge, got_val = (x[0].numpy()
                                  for x in tsift._refine(_t(dog)[None]))
    np.testing.assert_array_equal(got_ext, ref_ext)
    np.testing.assert_array_equal(got_edge, ref_edge)
    assert ref_ext.sum() > 10
    tame = np.all(np.abs(ref_off) < 1.5, axis=-1)
    np.testing.assert_array_equal(np.all(np.abs(got_off) < 1.5, axis=-1),
                                  tame)
    np.testing.assert_allclose(got_off[tame], ref_off[tame], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_val[tame], ref_val[tame], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_detect_octave_fed_reference_pyramid(ref_octaves, octave):
    """Top-K per octave on the reference's DoG: the same slots (the
    stable top-k keeps the zero slots in index order), and on the valid
    slots positions and σ within 1e-5 or 1 ulp (positions reach 170 px,
    where an f32 ulp is 1.5e-5)."""
    ref = ref_octaves[octave]
    oct_ = tss.Octave(gss=_t(ref["gss"])[None], dog=_t(ref["dog"])[None],
                      sigmas=(), downsample=1)
    got = [x[0].numpy() for x in tsift._detect_octave(
        oct_, 0.004, KPO, S_LEVELS, SIGMA0)]
    r_f, c_f, lvl, sigma, vals, valid = ref["det"]
    np.testing.assert_array_equal(got[5], valid)
    np.testing.assert_array_equal(got[2], lvl)
    for g, r in ((got[0], r_f), (got[1], c_f), (got[3], sigma),
                 (got[4], vals)):
        np.testing.assert_allclose(g[valid], r[valid], atol=1e-5,
                                   rtol=1.2e-7)


@pytest.mark.parametrize("octave", [0, 1])
def test_descriptors_fed_reference_keypoints(ref_octaves, octave):
    """Both descriptor forms (dense upright, sampled rotated) and the
    orientation histogram on the reference's mag/ang and keypoints:
    descriptors within 1e-5, orientations within 1e-5 rad with the same
    second-peak flags."""
    ref = ref_octaves[octave]
    r_f, c_f, lvl, sigma, _, valid = ref["det"]
    jargs = [jnp.asarray(a) for a in (ref["mag"], ref["ang"], lvl, r_f, c_f,
                                      sigma)]
    targs = [_t(a)[None] for a in (ref["mag"], ref["ang"], lvl, r_f, c_f,
                                   sigma)]
    targs[2] = targs[2].long()

    ref_dense = np.asarray(jsift._descriptors_dense(*jargs, S_LEVELS, SIGMA0))
    got_dense = tsift._descriptors_dense(*targs, S_LEVELS, SIGMA0)[0].numpy()
    np.testing.assert_allclose(got_dense[valid], ref_dense[valid], atol=1e-5,
                               rtol=0)

    ref_t1, ref_t2, ref_has2 = (np.asarray(x)
                                for x in jsift._orientations(*jargs))
    got_t1, got_t2, got_has2 = (x[0].numpy()
                                for x in tsift._orientations(*targs))
    np.testing.assert_array_equal(got_has2[valid], ref_has2[valid])
    np.testing.assert_allclose(got_t1[valid], ref_t1[valid], atol=1e-5)
    both = valid & ref_has2
    np.testing.assert_allclose(got_t2[both], ref_t2[both], atol=1e-5)

    theta = jnp.asarray(ref_t1)
    ref_rot = np.asarray(jsift._descriptors(*jargs, theta))
    got_rot = tsift._descriptors(*targs, _t(ref_t1)[None])[0].numpy()
    np.testing.assert_allclose(got_rot[valid], ref_rot[valid], atol=1e-5,
                               rtol=0)


def _match_sets(ref, got, desc_atol):
    """Each of the reference's valid keypoints found among the port's
    valid ones at the same uv (1e-3 px) and orientation (1e-2 rad):
    returns the matched share, after checking descriptors on matches."""
    rv, gv = ref["valid"], got["valid"]
    ruv, guv = ref["uv"][rv], got["uv"][gv]
    rth, gth = ref["orientation"][rv], got["orientation"][gv]
    close = (np.abs(ruv[:, None] - guv[None]).max(-1) < 1e-3) & (
        np.abs(rth[:, None] - gth[None]) < 1e-2)
    hit = close.any(1)
    j = close.argmax(1)
    np.testing.assert_allclose(got["desc"][gv][j[hit]], ref["desc"][rv][hit],
                               atol=desc_atol, rtol=0)
    return hit.mean(), int(rv.sum()), int(gv.sum())


@pytest.mark.parametrize("upright", [True, False])
def test_extract_sift_matches_jax(frames, upright):
    """extract_sift on two frames at once vs the reference per frame:
    ≥ MIN_MATCHED of the valid keypoints matched as sets, descriptors
    within DESC_ATOL on matches, the valid counts within 2."""
    img = frames[0]
    got = tsift.extract_sift(_t(img), keypoints_per_octave=KPO,
                             upright=upright)
    k = 3 * KPO * (1 if upright else 2)
    assert got.desc.shape == (2, k, 128) and got.uv.shape == (2, k, 2)
    for f in range(2):
        ref = jax.tree.map(np.asarray, jsift.extract_sift(
            jnp.asarray(img[f]), keypoints_per_octave=KPO, upright=upright))
        share, n_ref, n_got = _match_sets(
            ref._asdict(), {n: x[f].numpy() for n, x in got._asdict().items()},
            DESC_ATOL[upright])
        assert share >= MIN_MATCHED and abs(n_ref - n_got) <= 2, (
            share, n_ref, n_got)


def test_extract_features_sift_matches_jax(frames):
    """extract_features_sift (defaults: 3 octaves × 96 = 288 slots) with
    the depth lift: matched keypoints carry the same xyz and validity."""
    got = textract(*(_t(a) for a in frames))
    assert got.uv.shape == (2, 288, 2) and got.desc.shape == (2, 288, 128)
    for f in range(2):
        ref = jax.tree.map(np.asarray, jextract(
            *(jnp.asarray(a[f]) for a in frames)))
        g = {n: x[f].numpy() for n, x in got._asdict().items()}
        r = ref._asdict()
        zero = np.zeros(288, np.float32)
        share, _, _ = _match_sets(dict(r, orientation=zero),
                                  dict(g, orientation=zero), DESC_ATOL[True])
        assert share >= MIN_MATCHED
        rv, gv = r["valid"], g["valid"]
        close = np.abs(r["uv"][rv][:, None] - g["uv"][gv][None]).max(-1) < 1e-3
        hit = close.any(1)
        np.testing.assert_allclose(g["xyz"][gv][close.argmax(1)[hit]],
                                   r["xyz"][rv][hit], atol=1e-6)
