"""The reference's last jitted sites as step programs, on the CPU where
each runs eagerly on the program's buffers: ``icp``, ``gicp``, ``epnp``,
``epnp_camera``, ``dls_pnp`` and ``bootstrap_state`` (with
``bootstrap_batched``), and the capture-safe eigensolvers they run
(``ops/sym_eig.py``).

* ``sym3_eigh`` and ``jacobi_eigh`` in f64 against ``numpy.linalg.eigh``:
  eigenvalues within EIG_TOL·max|A|, VᵀV within EIG_TOL of I, V·diag(w)·Vᵀ
  within EIG_TOL·max|A| of A, each eigenvector of a simple eigenvalue
  within VEC_TOL of numpy's up to sign (1 − |v·v_ref|), and a repeated
  root's eigenspace by its projector within VEC_TOL. In f32 the same
  checks at F32_TOL (sym3) and F32_JACOBI_TOL (Jacobi, 12 × 12); measured
  1.1e-7 and 2.7e-6.
* Each program against a plain loop of its bodies, bit for bit; one
  program per key whatever ``iters``; the key holding what the graph
  bakes in (``trim_dist``, ``min_inliers``, ``k_neighbors``, ``eps``,
  ``gn_iters``, the camera, the bootstrap's cfg); results that own their
  storage; no ``torch.linalg.eigh``/``lstsq`` on any solver's path.

The solvers' parity with the JAX reference is
``tests/test_torch_pnp_icp.py``'s; this file imports no JAX. Inputs are
numpy-seeded: that file's scenes, and one rendered corridor frame (the
port's ``render_sequence``, tilted toward a floor) through the FAST
frontend for the bootstrap.
"""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from pre3_tpu_torch.data.synthetic import render_sequence
from pre3_tpu_torch.ekf import slam as tslam
from pre3_tpu_torch.frontend.pipeline import Features, fast_features
from pre3_tpu_torch.geometry.camera import sr4000_camera
from pre3_tpu_torch.ops.sym_eig import jacobi_eigh, sym3_eigh
from pre3_tpu_torch.utils import graphs
from pre3_tpu_torch.vo import icp as ticp
from pre3_tpu_torch.vo import pnp as tpnp

EIG_TOL, VEC_TOL = 1e-12, 1e-10
F32_TOL, F32_JACOBI_TOL = 1e-6, 1e-5
CAM = sr4000_camera()
K, KF = 24, 64


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _owns_nothing(tree):
    """No tensor of ``tree`` lies in a program buffer."""
    held = {t.untyped_storage().data_ptr() for p in graphs.programs()
            for t in tree_leaves(p.buffers) if t is not None}
    assert all(t.untyped_storage().data_ptr() not in held
               for t in tree_leaves(tree))


# --------------------------------------------------------------------------
# The eigensolvers
# --------------------------------------------------------------------------

def _rotation(n, seed):
    return np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))[0]


def _epnp_mtm(n=40, seed=0):
    """EPnP's MᵀM (12 × 12, f64) on exact correspondences of
    test_torch_pnp_icp.py's scene: rank 11, its null vector the camera-
    frame control points."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                   rng.uniform(1.5, 4.0, n)], -1)
    r = _rodrigues(rng.uniform(-0.15, 0.15, 3))
    pc = pw @ r.T + rng.uniform(-0.3, 0.3, 3)
    uv = pc[:, :2] / pc[:, 2:3]
    pw_t = torch.as_tensor(pw)
    w = torch.ones(n, dtype=torch.float64)
    alpha = tpnp._barycentric(pw_t, tpnp._control_points(pw_t, w)).numpy()
    zero = np.zeros_like(alpha)
    m_u = np.stack([alpha, zero, -alpha * uv[:, :1]], -1)
    m_v = np.stack([zero, alpha, -alpha * uv[:, 1:]], -1)
    m = np.concatenate([m_u, m_v]).reshape(2 * n, 12)
    return m.T @ m


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    k = k / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _matrices(n):
    """name → symmetric [n, n] (f64) of each case."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2 * n, n))
    q = _rotation(n, n + 1)
    roots = np.arange(1.0, n + 1)
    roots[1] = roots[2]  # a repeated root
    cases = {"spd": x.T @ x, "repeated": q @ np.diag(roots) @ q.T,
             "diagonal": np.diag(rng.permutation(roots))}
    if n == 12:
        cases["epnp_mtm"] = _epnp_mtm()
    return cases


def _check_eigh(a, w, v, tol, vec_tol):
    wr, vr = np.linalg.eigh(a)
    scale = np.abs(a).max()
    n = a.shape[-1]
    assert np.abs(w - wr).max() <= tol * scale
    assert np.abs(v.T @ v - np.eye(n)).max() <= tol
    assert np.abs(v @ np.diag(w) @ v.T - a).max() <= tol * scale
    # eigenvectors of simple roots up to sign; a repeated root's space
    gap = np.diff(wr) > 1e-6 * scale
    simple = np.concatenate([[True], gap]) & np.concatenate([gap, [True]])
    for i in np.flatnonzero(simple):
        assert 1 - abs(v[:, i] @ vr[:, i]) <= vec_tol
    same = ~simple
    if same.any():
        pv, pr = v[:, same] @ v[:, same].T, vr[:, same] @ vr[:, same].T
        assert np.abs(pv - pr).max() <= vec_tol


@pytest.mark.parametrize("case", ["spd", "repeated", "diagonal"])
def test_sym3_eigh_matches_numpy(case):
    """sym3_eigh in f64 on a batch (the case and 64 random SPD matrices)
    against numpy's eigh in f64; the case alone again in f32."""
    a = _matrices(3)[case]
    x = np.random.default_rng(5).normal(size=(64, 3, 3))
    batch = np.concatenate([a[None], x @ np.swapaxes(x, -1, -2)])
    w, v = sym3_eigh(torch.as_tensor(batch))
    for i in range(len(batch)):
        _check_eigh(batch[i], w[i].numpy(), v[i].numpy(), EIG_TOL, VEC_TOL)
    w, v = sym3_eigh(torch.as_tensor(a, dtype=torch.float32))
    wr = np.linalg.eigh(a)[0]
    assert np.abs(w.numpy() - wr).max() <= F32_TOL * np.abs(a).max()
    vv = v.double().numpy()
    assert np.abs(vv.T @ vv - np.eye(3)).max() <= F32_TOL


def test_sym3_eigh_degenerate():
    """A multiple of the identity gives the identity basis; a rank-1 and a
    zero matrix stay orthonormal with their roots exact."""
    a = torch.stack([2.5 * torch.eye(3, dtype=torch.float64),
                     torch.zeros(3, 3, dtype=torch.float64),
                     torch.outer(*[torch.tensor([1.0, 2.0, 2.0],
                                                dtype=torch.float64)] * 2)])
    w, v = sym3_eigh(a)
    assert torch.equal(v[0], torch.eye(3, dtype=torch.float64))
    assert torch.equal(w[0], torch.full((3,), 2.5, dtype=torch.float64))
    assert torch.equal(w[1], torch.zeros(3, dtype=torch.float64))
    _check_eigh(a[2].numpy(), w[2].numpy(), v[2].numpy(), EIG_TOL, VEC_TOL)


@pytest.mark.parametrize("case", ["spd", "repeated", "diagonal",
                                  "epnp_mtm"])
def test_jacobi_eigh_matches_numpy(case):
    """jacobi_eigh at 12 × 12 in f64 against numpy's eigh in f64 (EPnP's
    rank-deficient MᵀM: its null vector to VEC_TOL, MᵀM·v₀ to EIG_TOL),
    and in f32 at F32_JACOBI_TOL."""
    a = _matrices(12)[case]
    w, v = jacobi_eigh(torch.as_tensor(a))
    _check_eigh(a, w.numpy(), v.numpy(), EIG_TOL, VEC_TOL)
    if case == "epnp_mtm":
        assert np.abs(a @ v[:, 0].numpy()).max() <= EIG_TOL * np.abs(a).max()
    w, v = jacobi_eigh(torch.as_tensor(a, dtype=torch.float32))
    scale = np.abs(a).max()
    vv = v.double().numpy()
    assert np.abs(w.numpy() - np.linalg.eigh(a)[0]).max() <= (
        F32_JACOBI_TOL * scale)
    assert np.abs(vv @ np.diag(w.double().numpy()) @ vv.T - a).max() <= (
        F32_JACOBI_TOL * scale)


def test_jacobi_eigh_batched_odd_order():
    """A batch of 7 × 7 matrices (an odd order: each round leaves one
    index out) in f64."""
    x = np.random.default_rng(9).normal(size=(4, 7, 7))
    a = x + np.swapaxes(x, -1, -2)
    w, v = jacobi_eigh(torch.as_tensor(a))
    for i in range(4):
        _check_eigh(a[i], w[i].numpy(), v[i].numpy(), EIG_TOL, VEC_TOL)


# --------------------------------------------------------------------------
# The solvers as programs
# --------------------------------------------------------------------------

def _scene(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                     rng.uniform(1.5, 4.0, n)], -1).astype(np.float32)


def _pose(seed, t_scale, r_scale):
    rng = np.random.default_rng(seed)
    return (_rodrigues(rng.uniform(-r_scale, r_scale, 3)).astype(np.float32),
            rng.uniform(-t_scale, t_scale, 3).astype(np.float32))


def _clouds(seed=8, n=120):
    """(p, q, valid_p, valid_q): q = p moved by a small pose, 1 mm noise,
    a few invalid points."""
    p = _scene(n, seed)
    r, t = _pose(seed + 1, 0.06, 0.05)
    q = (p - t) @ r + np.random.default_rng(seed + 2).normal(
        0, 1e-3, p.shape).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::17] = False
    return [torch.as_tensor(x) for x in (p, q, valid, np.roll(valid, 3))]


def _pnp(seed=3, n=50, pixels=False):
    """(pw, uv, valid): normalized coordinates with 5e-4 noise, or the
    SR4000 pixels of the same points."""
    pw = _scene(n, seed)
    r, t = _pose(seed + 1, 0.1, 0.1)
    pc = pw @ r.T + t
    uv = pc[:, :2] / pc[:, 2:3] + np.random.default_rng(seed + 2).normal(
        0, 5e-4, (n, 2))
    if pixels:
        from pre3_tpu_torch.geometry.camera import distort
        uv = distort(CAM, torch.as_tensor(uv * CAM.f + [CAM.cx, CAM.cy]))
    valid = np.ones(n, bool)
    valid[-5:] = False
    return [torch.as_tensor(np.asarray(x, np.float32) if x.dtype != bool
                            else x) for x in (pw, np.asarray(uv), valid)]


def _icp_loop(p, q, vp, vq, iters, trim_dist=0.25, min_inliers=6, r0=None,
              t0=None):
    r, t = ticp._start(r0, t0, p)
    for _ in range(iters):
        r, t = ticp._icp_step(p, q, vp, vq, r, t, trim_dist)
    return ticp._finish(p, q, vp, vq, r, t, trim_dist, min_inliers)


def _gicp_loop(p, q, vp, vq, iters, trim_dist=0.25, min_inliers=6,
               k_neighbors=8, eps=1e-3):
    cp = ticp.surface_covariances(p, vp, k=k_neighbors, eps=eps)
    cq = ticp.surface_covariances(q, vq, k=k_neighbors, eps=eps)
    r, t = ticp._start(None, None, p)
    for _ in range(iters):
        r, t = ticp._gicp_step(p, q, vp, vq, cp, cq, r, t, trim_dist)
    return ticp._finish(p, q, vp, vq, r, t, trim_dist, min_inliers)


def _dls_loop(pw, uv, valid, iters):
    seed = tpnp._epnp(pw, uv, valid, 5)
    w, proj = tpnp._dls_terms(pw, uv, valid)
    r, t = seed.r, seed.t
    for _ in range(iters):
        r, t = tpnp._dls_step(pw, proj, w, r, t)
    return tpnp.PnpResult(r, t, seed.ok, tpnp._dls_cost(pw, proj, w, r, t))


SOLVERS = {  # name: (the program's call, its plain loop, inputs)
    "icp": (ticp.icp, _icp_loop, _clouds),
    "gicp": (ticp.gicp, _gicp_loop, _clouds),
    "dls_pnp": (tpnp.dls_pnp, _dls_loop, _pnp),
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_program_serves_every_iters(name):
    """3 and 5 iterations (and 0) replay one program, never keyed by
    ``iters``; each equals the plain loop of its bodies bit for bit, owns
    its storage, and the solve converges."""
    run, loop, inputs = SOLVERS[name]
    args = inputs()
    graphs.clear()
    for iters in (3, 5, 0):
        got = run(*args, iters=iters)
        _bit_equal(got, loop(*args, iters))
        _owns_nothing(got)
        assert [p.name for p in graphs.programs()] == [name]
    assert bool(run(*args, iters=5).ok)


@pytest.mark.parametrize("name,change", [
    ("icp", dict(trim_dist=0.01)), ("icp", dict(min_inliers=500)),
    ("gicp", dict(eps=0.1)), ("gicp", dict(k_neighbors=5)),
    ("gicp", dict(trim_dist=0.01))])
def test_icp_key_holds_what_the_graph_bakes(name, change):
    """Two solves of the same clouds, the second with one baked-in value
    changed: two programs, each result its own plain loop's, and the two
    differ."""
    run, loop, inputs = SOLVERS[name]
    args = inputs()
    graphs.clear()
    first, second = run(*args, iters=3), run(*args, iters=3, **change)
    _bit_equal(first, loop(*args, 3))
    _bit_equal(second, loop(*args, 3, **change))
    assert any(not torch.equal(a, b) for a, b in zip(first, second))
    assert [p.name for p in graphs.programs()] == [name] * 2


def test_icp_start_is_a_key_and_an_input():
    """An initial guess (r0, t0) keys its own program (the start is then
    the caller's, copied in with the clouds): two guesses share it, each
    equal to its plain loop."""
    args = _clouds()
    graphs.clear()
    _bit_equal(ticp.icp(*args, iters=2), _icp_loop(*args, 2))
    for ang in (0.01, -0.02):
        r0 = torch.as_tensor(_rodrigues(np.array([0.0, ang, 0.0])),
                             dtype=torch.float32)
        t0 = torch.tensor([ang, 0.0, 0.0])
        _bit_equal(ticp.icp(*args, iters=2, r0=r0, t0=t0),
                   _icp_loop(*args, 2, r0=r0, t0=t0))
    assert [p.name for p in graphs.programs()] == ["icp"] * 2


def test_epnp_programs_key_gn_iters_and_camera():
    """epnp keyed by ``gn_iters``, epnp_camera by the camera too: each
    call equal to the plain EPnP body (after the camera's undistortion),
    one program per key."""
    pw, uv, valid = _pnp()
    pw_px, uv_px, valid_px = _pnp(pixels=True)
    cam2 = CAM._replace(f=CAM.f * 1.01)
    graphs.clear()
    for gn in (5, 2, 5):
        _bit_equal(tpnp.epnp(pw, uv, valid, gn_iters=gn),
                   tpnp._epnp(pw, uv, valid, gn))
    for cam in (CAM, cam2, CAM):
        got = tpnp.epnp_camera(cam, pw_px, uv_px, valid_px)
        _bit_equal(got, tpnp._epnp(pw_px, tpnp._normalized(cam, uv_px),
                                   valid_px, 5))
        _owns_nothing(got)
        assert bool(got.ok)
    assert [p.name for p in graphs.programs()] == (["epnp"] * 2
                                                   + ["epnp_camera"] * 2)


@pytest.mark.parametrize("name", list(SOLVERS) + ["epnp"])
def test_solver_result_is_a_copy(name):
    """A second solve of other inputs of the same shapes rewrites the
    program's buffers, not the first solve's result."""
    run, _, inputs = SOLVERS.get(name, (tpnp.epnp, None, _pnp))
    kw = {} if name == "epnp" else dict(iters=3)
    first = run(*inputs(seed=8), **kw)
    kept = [x.clone() for x in first]
    second = run(*inputs(seed=11), **kw)
    _bit_equal(first, kept)
    assert not torch.equal(first.t, second.t)


def test_solvers_never_call_eigh_or_lstsq(monkeypatch):
    """The solvers' paths reach neither ``torch.linalg.eigh`` nor
    ``lstsq``: both raise here, and every solver still solves."""
    def refuse(*a, **k):
        raise AssertionError("a host-checked solver on a program's path")

    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    monkeypatch.setattr(torch.linalg, "lstsq", refuse)
    graphs.clear()
    for name, (run, _, inputs) in SOLVERS.items():
        assert bool(run(*inputs(), iters=2).ok)
    assert bool(tpnp.epnp(*_pnp()).ok)
    assert bool(tpnp.epnp_camera(CAM, *_pnp(pixels=True)).ok)


def test_lstsq_qr_matches_numpy():
    """The 6 × 3 β system's Householder solve against numpy's lstsq in
    f64, to 1e-12 relative."""
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(6, 3)), rng.normal(size=6)
    got = tpnp._lstsq_qr(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# The bootstrap
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """Three frames of a corridor pitched 20° toward a floor 1 m below:
    (FAST features [3, KF], intensity [3, H, W], xyz [3, H, W, 3])."""
    fr, _, _ = render_sequence(n_frames=3, n_points=300, noise=0.004,
                               floor_y=1.0, tilt_deg=-20.0)
    im = [torch.as_tensor(np.nan_to_num(np.stack([getattr(f, a)
                                                  for f in fr])))
          for a in ("intensity", "xyz", "confidence")]
    return fast_features(*im, threshold=0.05, max_features=KF), im[0], im[1]


def _boot_args(frames, i=0, seed=0):
    """One frame's bootstrap inputs with numpy-seeded draws: (first,
    xyz_img, image, plane_gumbel, add_gumbel)."""
    feats, image, xyz = frames
    rng = np.random.default_rng(seed)
    h, w = xyz.shape[1:3]
    n_region = (h - int(h * 0.6)) * w
    g = lambda *s: torch.as_tensor(  # noqa: E731
        rng.gumbel(size=s).astype(np.float32))
    return (tslam._frame(feats, i), xyz[i], image[i], g(512, n_region),
            g(KF))


CFG = tslam.SlamConfig(init_sampling="weighted", min_measured=50)


def test_bootstrap_program_equals_body_with_draws(frames):
    """bootstrap_state (the frame, images and injected draws copied into
    its program, one run, the state copied out) against bootstrap_body on
    the same inputs, bit for bit: the plane-fit prior is a real
    orientation and landmarks are seeded; the state owns its storage and
    a later call leaves it as it was."""
    graphs.clear()
    first, xyz, image, plane, add = _boot_args(frames)
    got = tslam.bootstrap_state(CAM, first, CFG, K, xyz_img=xyz, image=image,
                                plane_gumbel=plane, add_gumbel=add)
    ref = tslam.bootstrap_body(CAM, first, CFG, K, xyz, image, plane, add)
    _bit_equal(got, ref)
    assert abs(float(got.x[3])) < 0.999 and int(got.active.sum()) > 8
    _owns_nothing(got)
    kept = [x.clone() for x in got]
    other = _boot_args(frames, i=1, seed=1)
    tslam.bootstrap_state(CAM, other[0], CFG, K, xyz_img=other[1],
                          image=other[2], plane_gumbel=other[3],
                          add_gumbel=other[4])
    _bit_equal(got, kept)
    assert [p.name for p in graphs.programs()] == ["bootstrap_state"]


def test_bootstrap_program_equals_body_with_generator(frames):
    """The draws from a generator: the program and the body from two
    generators of one seed give the same state bit for bit and leave the
    generators in the same state; another cfg or map size keys another
    program."""
    graphs.clear()
    first, xyz, image, _, _ = _boot_args(frames)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    got = tslam.bootstrap_state(CAM, first, CFG, K, xyz_img=xyz,
                                generator=g1)
    ref = tslam.bootstrap_body(CAM, first, CFG, K, xyz, generator=g2)
    _bit_equal(got, ref)
    assert torch.equal(g1.get_state(), g2.get_state())
    tslam.bootstrap_state(CAM, first, CFG, K + 8, xyz_img=xyz, generator=g1)
    tslam.bootstrap_state(CAM, first, CFG._replace(max_adds=4), K,
                          xyz_img=xyz, generator=g1)
    assert [p.name for p in graphs.programs()] == ["bootstrap_state"] * 3


def test_bootstrap_batched_program_equals_bodies(frames):
    """bootstrap_batched at S = 3 with a generator per sequence: three runs
    of one program, each state copied into row s of the call's storage,
    equal bit for bit to the three bodies stacked."""
    feats = frames[0]
    first = Features(*(x[:3] for x in feats))
    graphs.clear()
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    got = tslam.bootstrap_batched(CAM, first, CFG, K, generators=gens)
    refs = [tslam.bootstrap_body(CAM, tslam._frame(feats, s), CFG, K,
                                 generator=torch.Generator().manual_seed(s))
            for s in range(3)]
    _bit_equal(got, tslam.EkfState(*map(torch.stack, zip(*refs))))
    assert not torch.equal(got.x[0], got.x[1])
    _owns_nothing(got)
    assert [p.name for p in graphs.programs()] == ["bootstrap_state"]
