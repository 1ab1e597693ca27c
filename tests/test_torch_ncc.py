"""Config #2's map matcher, port vs JAX reference: the warped-patch NCC
scan (ekf/ncc_matching.py) and what it reads — the raw init patches
recorded by add_features(image=...) and their warp into the current view
(frontend/patch_warp.py) — on the same numpy-seeded or rendered inputs.

Tolerances: patch values and NCC inputs are f32 sums of a few products,
so they agree to ~1e-6; the candidate grid is bit-equal to the
reference's jnp.linspace under jit (the form its run_slam runs; the eager
call rounds differently), so every reference call here is jitted. Every
discrete output (ic, the chosen candidate) is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.map_management import add_features as jadd_features
from pre3_tpu.ekf.measurement import predict_measurements as jpredict
from pre3_tpu.ekf.ncc_matching import search_ic_matches_ncc as jsearch
from pre3_tpu.ekf.state import init_state as jinit_state
from pre3_tpu.frontend import patch_warp as jpw
from pre3_tpu.frontend.pipeline import Features as JFeatures
from pre3_tpu.geometry.camera import project as jproject
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu.geometry.quaternion import r2q as jr2q
from pre3_tpu_torch.ekf.map_management import add_features
from pre3_tpu_torch.ekf.ncc_matching import grid_unit, search_ic_matches_ncc
from pre3_tpu_torch.frontend import patch_warp as tpw
from pre3_tpu_torch.frontend.pipeline import extract_features
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.utils.interop import to_numpy, to_torch

K, KF, PB = 32, 64, 21


@pytest.fixture(scope="module")
def scene():
    """Two rendered frames, their FAST features (the port's, as numpy,
    fed to both packages) and the camera-1 pose in camera 0's frame."""
    frames, traj, _ = render_sequence(n_frames=2, n_points=300, noise=0.004)
    stack = [torch.as_tensor(np.stack([getattr(f, a) for f in frames]))
             for a in ("intensity", "xyz", "confidence")]
    feats = to_numpy(extract_features(*stack, threshold=0.05,
                                      max_features=KF))
    t1 = (traj.t[1] - traj.t[0]) @ traj.r[0]
    q1 = np.asarray(jr2q(jnp.asarray(traj.r[0].T @ traj.r[1])))
    images = [np.stack([getattr(f, a) for f in frames])
              for a in ("intensity", "xyz")]
    images[1] = np.nan_to_num(images[1])
    return feats, images, np.r_[t1, q1].astype(np.float32)


def _frame(feats, i):
    return JFeatures(*(x[i] for x in feats))


def test_extract_raw_patches_matches_jax(scene):
    """21×21 raw patches at random centres, borders included (clamped
    bilinear reads): within 1e-6."""
    _, (intensity, _), _ = scene
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(-3, 179, 40), rng.uniform(-3, 147, 40)],
                  -1).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        jpw.extract_raw_patches, size=PB))(jnp.asarray(intensity[0]),
                                           jnp.asarray(uv)))
    got = tpw.extract_raw_patches(torch.as_tensor(intensity[0]),
                                  torch.as_tensor(uv), size=PB).numpy()
    assert got.shape == (40, PB, PB)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _warp_problem(k: int, seed: int):
    """Init and current camera poses, landmarks 2–4 m in front of the
    init camera, their pixels in both views and random raw patches."""
    rng = np.random.default_rng(seed)

    def quat(scale):
        q = np.r_[1.0, rng.normal(scale=scale, size=3)]
        return (q / np.linalg.norm(q)).astype(np.float32)

    init_cams = np.stack([np.r_[rng.normal(scale=0.05, size=3), quat(0.03)]
                          for _ in range(k)]).astype(np.float32)
    cur_cam = np.r_[rng.normal(scale=0.05, size=3), quat(0.03)].astype(
        np.float32)
    p_i = np.stack([rng.uniform(-0.8, 0.8, k), rng.uniform(-0.6, 0.6, k),
                    rng.uniform(2.0, 4.0, k)], -1).astype(np.float32)
    from pre3_tpu.geometry.quaternion import qconj, qrotate

    lms = np.asarray(jax.vmap(qrotate)(jnp.asarray(init_cams[:, 3:]),
                                       jnp.asarray(p_i))) + init_cams[:, :3]
    cam = jcamera()
    init_uv = np.asarray(jproject(cam, jnp.asarray(p_i)))
    p_c = np.asarray(qrotate(qconj(jnp.asarray(cur_cam[3:]))[None],
                             jnp.asarray(lms - cur_cam[:3])))
    h_pred = np.asarray(jproject(cam, jnp.asarray(p_c))) + rng.normal(
        scale=0.5, size=(k, 2))
    patches = rng.uniform(0.0, 1.0, size=(k, PB, PB))
    return [a.astype(np.float32) for a in
            (patches, init_uv, init_cams, cur_cam, lms, h_pred)]


def test_predict_patches_matches_jax():
    """16 features, each with its own init pose: the warped, zero-mean,
    unit-norm 11×11 appearance within 1e-5 of the reference's one-hot
    contraction (the port gathers the same four taps), and the
    single-feature form equal to its batch row."""
    args = _warp_problem(16, seed=3)
    ref = np.asarray(jax.jit(functools.partial(
        jpw.predict_patches, jcamera()))(*map(jnp.asarray, args)))
    targs = [torch.as_tensor(a) for a in args]
    got = tpw.predict_patches(tcamera(), *targs).numpy()
    assert got.shape == (16, 121)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    one = tpw.predict_patch_appearance(
        tcamera(), *(a[5] for a in targs[:3]), targs[3], targs[4][5],
        targs[5][5]).numpy()
    np.testing.assert_array_equal(one, got[5])


def test_grid_unit_is_the_rounded_linspace():
    """The candidate offsets are jnp.linspace(-1, 1, G) as jit rounds it:
    within 7.5e-8 of the correctly rounded -1 + 2i/(G-1), ends exact."""
    for g in (5, 13, 21):
        got = grid_unit(g).numpy()
        exact = (-1.0 + 2.0 * np.arange(g) / (g - 1)).astype(np.float32)
        assert np.abs(exact - got).max() <= 7.5e-8
        assert got[0] == -1.0 and got[-1] == 1.0


def test_grid_unit_equals_jitted_linspace():
    """grid_unit(G) equals the reference's jitted jnp.linspace(-1, 1, G)
    bit for bit for every G from 2 to 39."""
    for g in range(2, 40):
        ref = np.asarray(jax.jit(lambda g=g: jnp.linspace(-1.0, 1.0, g))())
        got = grid_unit(g).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, ref), g


@pytest.fixture(scope="module")
def jax_map(scene):
    """The reference's map of K slots bootstrapped from frame 0 with its
    init patches recorded (add_features(image=...)), then moved to the
    true frame-1 pose."""
    feats, (intensity, _), pose1 = scene
    st = jinit_state(n_landmarks=K, desc_dim=feats.desc.shape[-1])
    added = jax.jit(functools.partial(
        jadd_features, jcamera(), max_adds=K, min_measured=50))(
        st, jax.tree.map(jnp.asarray, _frame(feats, 0)),
        jnp.zeros((K, 2)), jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32), image=jnp.asarray(intensity[0]))
    return jax.tree.map(np.asarray, added), pose1


def test_add_features_records_init_patches(scene, jax_map):
    """add_features(image=...) records each new landmark's 21×21 raw
    patch, init pixel and init pose as the reference does (patches within
    1e-6, pixels and poses equal), and the rest of the state as before;
    without an image init_patch stays as it was."""
    feats, (intensity, _), _ = scene
    ref, _ = jax_map
    tst = to_torch(jax.tree.map(np.asarray, jinit_state(
        n_landmarks=K, desc_dim=feats.desc.shape[-1])), device="cpu")
    frame = to_torch(_frame(feats, 0), device="cpu")
    args = (tcamera(), tst, frame, torch.zeros(K, 2),
            torch.tensor(0, dtype=torch.int32), torch.tensor(0))
    got = to_numpy(add_features(*args, max_adds=K, min_measured=50,
                                image=torch.as_tensor(intensity[0])))
    assert ref.active.sum() > 10 and np.abs(ref.init_patch).sum() > 0
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
    plain = add_features(*args, max_adds=K, min_measured=50)
    assert torch.equal(plain.init_patch, tst.init_patch)
    np.testing.assert_array_equal(plain.init_uv.numpy(), got.init_uv)


def test_search_ic_matches_ncc_matches_jax(scene, jax_map):
    """The NCC scan of frame 1 from the true pose, at the published
    widths (grid 13, patch 11, threshold 0.60, gates 2–20 px): ic equal,
    matched pixels within 2e-6 px, their xyz samples within 1e-5 m."""
    _, (intensity, xyz), pose1 = scene
    ref_map, _ = jax_map
    st = ref_map._replace(x=ref_map.x.copy())
    st.x[0:7] = pose1
    jst = jax.tree.map(jnp.asarray, st)
    obs = jax.jit(functools.partial(jpredict, jcamera()))(jst)
    ref = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jsearch, jcamera()))(obs, jst, jnp.asarray(intensity[1]),
                             xyz_img=jnp.asarray(xyz[1])))
    got = to_numpy(search_ic_matches_ncc(
        tcamera(), to_torch(jax.tree.map(np.asarray, obs), device="cpu"),
        to_torch(st, device="cpu"), torch.as_tensor(intensity[1]),
        xyz_img=torch.as_tensor(xyz[1])))
    assert ref.ic.sum() >= 10
    np.testing.assert_array_equal(got.ic, ref.ic)
    np.testing.assert_allclose(got.z, ref.z, atol=2e-6)
    np.testing.assert_allclose(got.z_xyz, ref.z_xyz, atol=1e-5)
    # the other fields pass through untouched
    np.testing.assert_array_equal(got.h, np.asarray(obs.h))
    no_xyz = search_ic_matches_ncc(
        tcamera(), to_torch(jax.tree.map(np.asarray, obs), device="cpu"),
        to_torch(st, device="cpu"), torch.as_tensor(intensity[1]))
    assert not no_xyz.z_xyz.any() and np.array_equal(no_xyz.ic.numpy(),
                                                     got.ic)


def test_unmeasured_slots_stay_inside_the_image(scene, jax_map):
    """A slot with a NaN pixel and S (still flagged visible) and one
    whose pixel overflowed to ±3.4e31 (out of view) are scanned about
    the image's centre: no index leaves the image, neither is matched,
    their z and z_xyz are 0, and every other slot's z, ic and z_xyz are
    bit-equal to the scan without them."""
    _, (intensity, xyz), pose1 = scene
    ref_map, _ = jax_map
    st = ref_map._replace(x=ref_map.x.copy())
    st.x[0:7] = pose1
    tst = to_torch(st, device="cpu")
    obs = to_torch(jax.tree.map(np.asarray, jax.jit(functools.partial(
        jpredict, jcamera()))(jax.tree.map(jnp.asarray, st))), device="cpu")
    args = (torch.as_tensor(intensity[1]),)
    kw = dict(xyz_img=torch.as_tensor(xyz[1]))
    plain = search_ic_matches_ncc(tcamera(), obs, tst, *args, **kw)
    nan_slot, far_slot = torch.nonzero(plain.ic)[:2, 0].tolist()
    h, s, visible = obs.h.clone(), obs.s.clone(), obs.visible.clone()
    h[nan_slot], s[nan_slot] = float("nan"), float("nan")
    h[far_slot] = torch.tensor([3.4e31, -3.4e31])
    visible[far_slot] = False
    got = search_ic_matches_ncc(
        tcamera(), obs._replace(h=h, s=s, visible=visible), tst, *args, **kw)
    dead = torch.zeros(K, dtype=torch.bool)
    dead[[nan_slot, far_slot]] = True
    assert not got.ic[dead].any()
    assert not got.z[dead].any() and not got.z_xyz[dead].any()
    for name in ("z", "ic", "z_xyz"):
        assert torch.equal(getattr(got, name)[~dead],
                           getattr(plain, name)[~dead]), name
    assert torch.isnan(got.h[nan_slot]).all()  # obs passes through


def test_predict_patches_reads_inside_a_dead_slots_patch():
    """An inactive slot (zero init patch, pixel and pose, a landmark at
    the world origin) with a NaN or overflowed pixel reads no tap outside
    its patch; its row is NaN, and every other row is bit-equal to the
    warp without it."""
    args = [torch.as_tensor(a) for a in _warp_problem(16, seed=3)]
    plain = tpw.predict_patches(tcamera(), *args)
    patches, init_uv, init_cams, cur_cam, lms, h_pred = (
        a.clone() for a in args)
    for slot, h in ((4, [float("nan")] * 2), (9, [3.4e31, -3.4e31]),
                    (11, [88.0, 72.0])):
        patches[slot], init_uv[slot], init_cams[slot], lms[slot] = 0, 0, 0, 0
        h_pred[slot] = torch.tensor(h)
    got = tpw.predict_patches(tcamera(), patches, init_uv, init_cams,
                              cur_cam, lms, h_pred)
    live = torch.ones(16, dtype=torch.bool)
    live[[4, 9, 11]] = False
    assert torch.equal(got[live], plain[live])
    assert torch.isnan(got[[4, 9]]).all()


def test_ncc_step_with_the_origin_on_the_camera_plane(scene):
    """One ncc_warp slam_step from a map with free slots (zeros: a
    Cartesian point at the world origin) whose camera has the origin on
    its own plane, so that those slots' pixels and S are not finite: the
    step completes and its state is finite."""
    from pre3_tpu_torch.ekf import slam as tslam
    from pre3_tpu_torch.ekf.measurement import predict_measurements

    feats, (intensity, xyz), _ = scene
    cfg = tslam.SlamConfig(matcher="ncc_warp", motion_model="cv",
                           min_measured=50, max_update_slots=24)
    frames = [to_torch(_frame(feats, i), device="cpu") for i in (0, 1)]
    images = [torch.as_tensor(a) for a in intensity]
    gen = torch.Generator().manual_seed(3)
    st = tslam.bootstrap_state(tcamera(), frames[0], cfg, 2 * KF,
                               image=images[0], generator=gen)
    # the camera 1 m along x from the origin, looking along z, at rest
    st = st._replace(x=torch.cat([torch.tensor([1.0, 0.0, 0.0]),
                                  st.x[3:7], torch.zeros(6), st.x[13:]]))
    assert (~st.active).sum() >= KF
    obs = predict_measurements(tcamera(), st)
    assert not torch.isfinite(obs.h[~st.active]).all()
    new, _ = tslam.slam_step(
        tcamera(), st, frames[1], frames[0], torch.tensor(1, dtype=torch.int32),
        cfg, generator=gen, image=images[1], xyz_img=torch.as_tensor(xyz[1]))
    assert torch.isfinite(new.x).all() and torch.isfinite(new.p).all()
