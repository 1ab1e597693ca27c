"""The EKF's heading, attitude and iterated updates, port vs JAX reference,
on the reference's own bootstrapped and predicted state (the ``case`` of
tests/test_torch_ekf.py: a 24-slot map from a rendered frame, predicted
with a VO increment and matched against the next frame)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.ekf import update as jupd
from pre3_tpu.geometry.camera import sr4000_camera as jcamera
from pre3_tpu.geometry.quaternion import q2e as jq2e
from pre3_tpu_torch.ekf import update as tupd
from pre3_tpu_torch.geometry.camera import sr4000_camera as tcamera
from pre3_tpu_torch.utils.interop import to_numpy, to_torch
from test_torch_ekf import _close, _jit, _np, _rodrigues, case  # noqa: F401

# x within 2e-6 and P within 1e-8 (entries ≤ 1e-3), as the Kalman update
# of test_torch_ekf.py: the same algebra, another order of reductions.
X_ATOL, P_ATOL = 2e-6, 1e-8


def _state(case):
    return case["st1"]


def _jstate(st):
    return jax.tree.map(jnp.asarray, st)


def _up_rotated(st, deg):
    """The filter's predicted camera-frame up axis, turned by ``deg``
    about the camera's x axis."""
    q = st.x[3:7].astype(np.float64)
    w, v = q[0], -q[1:]  # q⁻¹
    up = np.array([0.0, -1.0, 0.0])
    t = 2.0 * np.cross(v, up)
    h = up + w * t + np.cross(v, t)
    return (_rodrigues(np.array([math.radians(deg), 0, 0])) @ h).astype(
        np.float32)


@pytest.mark.parametrize("dyaw", [0.05, -0.3, 2 * math.pi - 0.1])
def test_heading_update_matches_jax(case, dyaw):
    """Yaw observations off the state's yaw (the last wraps around):
    x, P within X_ATOL, P_ATOL; the port's gradient stays float32."""
    st = _state(case)
    yaw = float(jq2e(jnp.asarray(st.x[3:7]))[2])
    z = np.float32(yaw + dyaw)
    ref = _np(_jit(jupd.heading_update)(_jstate(st), jnp.asarray(z)))
    got = tupd.heading_update(to_torch(st, device="cpu"), torch.tensor(z))
    assert got.x.dtype == got.p.dtype == torch.float32
    _close(got, ref, atol=X_ATOL, fields=("x",))
    _close(got, ref, atol=P_ATOL, fields=("p",))
    assert np.abs(ref.x - st.x).max() > 1e-5  # the update did something


@pytest.mark.parametrize("deg,ok,applied", [
    (2.0, True, True),  # inside the 4° gate
    (6.0, True, False),  # beyond it: rejected on the device
    (2.0, False, False),  # the plane fit failed
])
def test_attitude_update_matches_jax(case, deg, ok, applied):
    """Gravity-direction update from an 'up' observation turned by deg
    from the prediction: applied (x, P within tolerance, the state
    moved) or rejected (the state returned unchanged, bit for bit)."""
    st = _state(case)
    up = _up_rotated(st, deg)
    ref = _np(_jit(jupd.attitude_update)(_jstate(st), jnp.asarray(up),
                                         jnp.asarray(ok)))
    got = tupd.attitude_update(to_torch(st, device="cpu"), torch.tensor(up),
                               torch.tensor(ok))
    _close(got, ref, atol=X_ATOL, fields=("x",))
    _close(got, ref, atol=P_ATOL, fields=("p",))
    moved = np.abs(to_numpy(got).x - st.x).max() > 1e-5
    assert moved == applied
    if not applied:
        np.testing.assert_array_equal(to_numpy(got).p, st.p)


@pytest.mark.parametrize("n_iters", [1, 3])
def test_iterated_kalman_update_matches_jax(case, n_iters):
    """IEKF on every IC match of the case: x within 1e-5 (three
    relinearizations, each a dense [2K, D] LU solve), P within 1e-8; one
    iteration equals the plain update's algebra."""
    st, obs = _state(case), case["obs"]
    ref = _np(_jit(jupd.iterated_kalman_update, jcamera(),
                   n_iters=n_iters)(_jstate(st), jnp.asarray(obs.z),
                                    jnp.asarray(obs.ic)))
    got = tupd.iterated_kalman_update(
        tcamera(), to_torch(st, device="cpu"), torch.as_tensor(obs.z),
        torch.as_tensor(obs.ic), n_iters=n_iters)
    _close(got, ref, atol=1e-5, fields=("x",))
    _close(got, ref, atol=P_ATOL, fields=("p",))
    assert np.abs(ref.x - st.x).max() > 1e-4


def test_assemble_h_matches_jax(case):
    """Dense stacked H: exactly the reference's (a placement, no sums)."""
    obs = case["obs"]
    ref = np.asarray(jupd.assemble_h(_jstate(obs), jnp.asarray(obs.ic)))
    got = tupd.assemble_h(to_torch(obs, device="cpu"),
                          torch.as_tensor(obs.ic)).numpy()
    np.testing.assert_array_equal(got, ref)
