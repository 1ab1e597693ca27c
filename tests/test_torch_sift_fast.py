"""The SIFT frontend's fast-math branch: the port vs the JAX reference.

``PRE3_SIFT_FAST_MATH=1`` forces the reference's fast branch on the CPU
(``approx_max_k`` top-k, bf16 band filters with f32 accumulation, bf16
descriptor taps). Each reference program is a fresh ``jax.jit`` traced
under the variable, as ``tests/test_sift.py`` does: the reference reads
it at trace time. The port reads it when ``extract_sift`` is called.
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
from pre3_tpu_torch.ekf.slam import SlamConfig
from pre3_tpu_torch.frontend import sift as tsift
from pre3_tpu_torch.frontend.pipeline import (
    extract_features_sift as textract, extract_sequences,
)
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.parallel.mesh import make_mesh
from pre3_tpu_torch.runtime.online import OnlineSlam
from pre3_tpu_torch.runtime.stage_pipeline import sharded_extract

S_LEVELS = 3
SIGMA0 = 1.6 * 2.0 ** (1.0 / S_LEVELS)
KPO = 48
# _tri_sepconv: every term is non-negative, so a bf16 rounding of the
# input or of the intermediate that falls the other way moves an output
# by at most one bf16 spacing, 2^-7 of it. Read: bit-equal at Δ = 3 and
# 7.5 on every octave's shape. The exact branch differs from the
# reference's fast one in 99.999% of the entries, so at most 1% may
# differ at all.
SEPCONV_RTOL, SEPCONV_MAX_CHANGED = 2.0**-7, 0.01
# Descriptors fed the reference's keypoints and gradient stacks: read
# max 2.6e-5, 0.03% of the entries above 1e-5 (octave 0); the exact
# branch sits 8e-4–1.3e-3 from the reference's fast one.
DESC_FED_ATOL = 1e-4
# The whole extractor on two rendered frames: the pyramid summed in
# another order moves a keypoint by up to ~3e-4 px, and f32 values that
# differ by an ulp can round to neighbouring bf16 values (one spacing is
# 2^-8–2^-7 of a binned tap). Read: max 8.6e-4, 5–10% of the matched
# keypoints' entries above 1e-5, median per keypoint 3e-8 (the exact
# branch against the fast one: median 6.5e-4).
DESC_ATOL, DESC_MEDIAN = 1e-3, 1e-5
MIN_MATCHED = 0.98  # the exact-branch test's share (uv within 1e-3 px)


@pytest.fixture(scope="module")
def frames():
    fr, _, _ = render_sequence(n_frames=2, n_points=300, noise=0.004)
    return [np.stack([getattr(f, a) for f in fr]).astype(np.float32)
            for a in ("intensity", "xyz", "confidence")]


@pytest.fixture(scope="module")
def ref_octaves(frames):
    """The reference's pyramid, fast-branch detections and gradient
    stacks of frame 0, per octave (numpy)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRE3_SIFT_FAST_MATH", "1")
        octs = jax.jit(lambda im: [
            (o.gss, o.dog) for o in jss.build_pyramid(
                im, n_octaves=3, s_levels=S_LEVELS, sigma0=SIGMA0)])(
            jnp.asarray(frames[0][0]))
        out = []
        for gss, dog in octs:
            det = jax.jit(lambda d, g: jsift._detect_octave(
                jss.Octave(g, d, (), 1), 0.004, KPO, S_LEVELS, SIGMA0))(
                dog, gss)
            mag, ang = jax.vmap(jss.gradient_polar)(gss)
            out.append(jax.tree.map(np.asarray, dict(
                gss=gss, dog=dog, det=det, mag=mag, ang=ang)))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("value, fast", [(None, False), ("0", False),
                                         ("1", True)])
def test_switch_meanings(monkeypatch, frames, value, fast):
    """Unset and "0" run the exact branch, "1" the fast one, read at each
    call: the unset and "0" results are bit-equal, "1"'s descriptors
    differ from them."""
    monkeypatch.delenv("PRE3_SIFT_FAST_MATH", raising=False)
    img = _t(frames[0])
    exact = tsift.extract_sift(img, keypoints_per_octave=KPO)
    if value is not None:
        monkeypatch.setenv("PRE3_SIFT_FAST_MATH", value)
    assert tsift._fast_math() is fast
    got = tsift.extract_sift(img, keypoints_per_octave=KPO)
    assert torch.equal(got.uv, exact.uv)
    assert torch.equal(got.desc, exact.desc) is not fast


def test_every_entry_point_follows_the_switch(monkeypatch, frames):
    """extract_features_sift, extract_sequences, OnlineSlam(extractor=
    "sift") and sharded_extract all reach the branch the variable names
    at their call."""
    seen = []
    dense = tsift._descriptors_dense

    def spy(*args):
        seen.append(args[-1])
        return dense(*args)

    monkeypatch.setattr(tsift, "_descriptors_dense", spy)
    images = [_t(a) for a in frames]
    ek = {"keypoints_per_octave": KPO}

    def online():
        slam = OnlineSlam(sr4000_camera(), SlamConfig(), n_landmarks=16,
                          extractor="sift", extractor_kwargs=ek,
                          device="cpu")
        slam.process(*(a[0] for a in frames))

    calls = {
        "extract_features_sift": lambda: textract(*images, **ek),
        "extract_sequences": lambda: extract_sequences(
            textract, *(x[None] for x in images), **ek),
        "OnlineSlam": online,
        "sharded_extract": lambda: sharded_extract(
            make_mesh(1, device="cpu"), *images, extractor_kwargs=ek),
    }
    for value, fast in (("1", True), ("0", False)):
        monkeypatch.setenv("PRE3_SIFT_FAST_MATH", value)
        for name, call in calls.items():
            seen.clear()
            call()
            assert seen and all(f is fast for f in seen), (name, value, seen)


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_tri_sepconv_matches_reference_fast(monkeypatch, ref_octaves, octave):
    """The band filter on one octave's shape, bf16 operands and
    intermediate: within one bf16 spacing entrywise, and almost every
    entry bit-equal."""
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "1")
    _, h, w = ref_octaves[octave]["dog"].shape
    x = np.random.default_rng(octave).random((h, w, 8)).astype(np.float32)
    for delta in (3.0, 7.5):
        ref = np.asarray(jax.jit(lambda a: jsift._tri_sepconv(a, delta))(
            jnp.asarray(x)))
        got = tsift._tri_sepconv(_t(x)[None], delta, fast=True)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=SEPCONV_RTOL, atol=0)
        assert (got != ref).mean() <= SEPCONV_MAX_CHANGED


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_detect_and_descriptors_fed_reference(monkeypatch, ref_octaves,
                                              octave):
    """On the reference's DoG, the fast branch's top-k (approx_max_k on
    the CPU) picks the port's slots, positions within 1e-5 (as the exact
    branch's test); on its keypoints and gradient stacks the fast dense
    descriptors agree within DESC_FED_ATOL."""
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "1")
    ref = ref_octaves[octave]
    r_f, c_f, lvl, sigma, vals, valid = ref["det"]
    oct_ = tsift.Octave(gss=_t(ref["gss"])[None], dog=_t(ref["dog"])[None],
                        sigmas=(), downsample=1)
    det = [x[0].numpy() for x in tsift._detect_octave(
        oct_, 0.004, KPO, S_LEVELS, SIGMA0)]
    np.testing.assert_array_equal(det[5], valid)
    np.testing.assert_array_equal(det[2], lvl)
    for g, r in ((det[0], r_f), (det[1], c_f), (det[3], sigma),
                 (det[4], vals)):
        np.testing.assert_allclose(g[valid], r[valid], atol=1e-5,
                                   rtol=1.2e-7)

    jargs = [jnp.asarray(a) for a in (ref["mag"], ref["ang"], lvl, r_f, c_f,
                                      sigma)]
    targs = [_t(a)[None] for a in (ref["mag"], ref["ang"], lvl, r_f, c_f,
                                   sigma)]
    targs[2] = targs[2].long()
    want = np.asarray(jax.jit(lambda *a: jsift._descriptors_dense(
        *a, S_LEVELS, SIGMA0))(*jargs))
    got = tsift._descriptors_dense(*targs, S_LEVELS, SIGMA0,
                                   fast=True)[0].numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=DESC_FED_ATOL,
                               rtol=0)


def _matched(ref, got):
    """(share of the reference's valid keypoints found among the port's at
    uv within 1e-3 px, each match's largest descriptor error)."""
    rv, gv = ref["valid"], got["valid"]
    d = np.abs(ref["uv"][rv][:, None] - got["uv"][gv][None]).max(-1)
    hit = d.min(1) < 1e-3
    err = np.abs(got["desc"][gv][d.argmin(1)[hit]]
                 - ref["desc"][rv][hit]).max(-1)
    return hit.mean(), err


def test_extract_features_sift_matches_reference_fast(monkeypatch, frames):
    """The whole fast frontend on two frames at once against the
    reference's per frame: keypoints as sets (the exact-branch test's
    criterion), descriptors within DESC_ATOL, their median error within
    DESC_MEDIAN; the depth lift's validity equal."""
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "1")
    got = textract(*(_t(a) for a in frames), keypoints_per_octave=KPO)
    # the reference's extract_features_sift is jitted at module level: a
    # trace of it at these static arguments from an earlier test in this
    # process (the exact branch, say) would be reused inside the fresh
    # jit below, whatever the variable now says
    jax.clear_caches()
    fe = jax.jit(lambda i, x, c: jextract(i, x, c, keypoints_per_octave=KPO))
    errs = []
    for f in range(2):
        ref = jax.tree.map(np.asarray, fe(*(jnp.asarray(a[f])
                                            for a in frames)))._asdict()
        g = {n: x[f].numpy() for n, x in got._asdict().items()}
        share, err = _matched(ref, g)
        assert share >= MIN_MATCHED, share
        assert abs(int(ref["valid"].sum()) - int(g["valid"].sum())) <= 2
        errs.append(err)
    err = np.concatenate(errs)
    assert err.max() <= DESC_ATOL, err.max()
    assert np.median(err) <= DESC_MEDIAN, np.median(err)


def test_fast_close_to_exact_on_the_port(monkeypatch, frames):
    """The reference's fast-against-exact criteria (tests/test_sift.py::
    TestFastMathBranches) on the port: at least 80% of the exact keypoint
    count, more than 80% of the exact keypoints with a fast one within 1
    px, and co-located descriptors with median cosine above 0.99."""
    img = _t(frames[0][:1])
    xyz, conf = _t(frames[1][:1]), _t(frames[2][:1])
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "0")
    exact = textract(img, xyz, conf, keypoints_per_octave=KPO)
    monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "1")
    fast = textract(img, xyz, conf, keypoints_per_octave=KPO)
    uv_e = exact.uv[0][exact.valid[0]].numpy()
    uv_f = fast.uv[0][fast.valid[0]].numpy()
    assert len(uv_f) > 0.8 * len(uv_e)
    d = np.linalg.norm(uv_e[:, None] - uv_f[None], axis=-1)
    assert (d.min(axis=1) < 1.0).mean() > 0.8
    pairs = np.nonzero(d.min(axis=1) < 0.25)[0]
    de = exact.desc[0][exact.valid[0]].numpy()[pairs]
    df = fast.desc[0][fast.valid[0]].numpy()[d.argmin(axis=1)[pairs]]
    cos = np.sum(de * df, -1) / np.maximum(
        np.linalg.norm(de, axis=-1) * np.linalg.norm(df, axis=-1), 1e-9)
    assert len(pairs) >= 10
    assert float(np.median(cos)) > 0.99
