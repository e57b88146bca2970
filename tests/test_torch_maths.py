"""The port's quaternion, spatial and linalg functions against pbrl_tpu's
on the same numpy-seeded inputs.

Tolerances: 1e-6 absolute for the quaternion and spatial functions (float32
rounding of O(1) values); the 34x34 SPD solve to 1e-5 relative of the
solution against pbrl_tpu's unrolled solver (the same column algorithm,
products summed in another order) and to 1e-3 against numpy's float64
solve (the float32 conditioning of these matrices); the gradient of the
solve to 1e-4 relative against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.maths import quaternion as jq
from pbrl_tpu.maths import spatial as js
from pbrl_tpu.ops import linalg as jla
from pbrl_tpu_torch.maths import quaternion as tq
from pbrl_tpu_torch.maths import spatial as ts
from pbrl_tpu_torch.ops import linalg as tla


def _unit(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


QUAT_CASES = {
    "identity": (lambda q, v, w: jq.identity((5,)), lambda q, v, w: tq.identity((5,))),
    "inv": (lambda q, v, w: jq.inv(2.0 * q), lambda q, v, w: tq.inv(2.0 * q)),
    "from_axis_angle": (lambda q, v, w: jq.from_axis_angle(q[:, 1:] / jnp.linalg.norm(
        q[:, 1:], axis=1, keepdims=True), v[:, 0]),
        lambda q, v, w: tq.from_axis_angle(q[:, 1:] / torch.linalg.norm(
            q[:, 1:], dim=1, keepdim=True), v[:, 0])),
    "integrate": (lambda q, v, w: jq.integrate(q, v, 0.002),
                  lambda q, v, w: tq.integrate(q, v, 0.002)),
    "integrate_world": (lambda q, v, w: jq.integrate_world(q, v, 0.002),
                        lambda q, v, w: tq.integrate_world(q, v, 0.002)),
    "to_matrix": (lambda q, v, w: jq.to_matrix(q), lambda q, v, w: tq.to_matrix(q)),
    "from_matrix": (lambda q, v, w: jq.from_matrix(jq.to_matrix(q)),
                    lambda q, v, w: tq.from_matrix(tq.to_matrix(q))),
    "to_euler_rxyz": (lambda q, v, w: jq.to_euler_rxyz(q), lambda q, v, w: tq.to_euler_rxyz(q)),
    "box_minus": (lambda q, v, w: jq.box_minus(q, w, 1.0 / 60.0),
                  lambda q, v, w: tq.box_minus(q, w, 1.0 / 60.0)),
    "mul": (lambda q, v, w: jq.mul(q, w), lambda q, v, w: tq.mul_fused(q, w)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_matches_jax(name):
    rng = np.random.default_rng(0)
    q, w = _unit(rng, 64), _unit(rng, 64)
    # near a rotation of 2 pi and near the gimbal lock of the Euler angles
    q[0] = np.float32([0.0, 1.0, 0.0, 0.0])
    q[1] = np.float32([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0])
    w[2] = q[2]
    v = rng.normal(size=(64, 3)).astype(np.float32) * 3.0
    jf, tf = QUAT_CASES[name]
    want = jf(jnp.asarray(q), jnp.asarray(v), jnp.asarray(w))
    got = tf(_t(q), _t(v), _t(w))
    atol = 1e-4 if name == "box_minus" else 1e-6  # a rotation vector over dt = 1/60
    _close(got, want, atol=atol)


SPATIAL_CASES = ("skew", "inertia_at_origin", "motion_cross", "force_cross",
                 "point_velocity")


@pytest.mark.parametrize("name", SPATIAL_CASES)
def test_spatial_matches_jax(name):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(13, 6)).astype(np.float32)
    b = rng.normal(size=(13, 6)).astype(np.float32)
    p = rng.normal(size=(13, 3)).astype(np.float32)
    m = rng.uniform(0.5, 5.0, size=13).astype(np.float32)
    ic = rng.normal(size=(13, 3, 3)).astype(np.float32)
    ic = ic @ np.swapaxes(ic, 1, 2)
    if name == "skew":
        want, got = js.skew(jnp.asarray(p)), ts.skew(_t(p))
    elif name == "inertia_at_origin":
        want = js.inertia_at_origin(jnp.asarray(m), jnp.asarray(p), jnp.asarray(ic))
        got = ts.inertia_at_origin(_t(m), _t(p), _t(ic))
    elif name == "point_velocity":
        want, got = js.point_velocity(jnp.asarray(a), jnp.asarray(p)), ts.point_velocity(_t(a), _t(p))
    else:
        want = getattr(js, name)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(ts, name)(_t(a), _t(b))
    _close(got, want, atol=1e-5 if name == "inertia_at_origin" else 1e-6)


def _spd(rng, n, batch=()):
    a = rng.normal(size=batch + (n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 17, 34])
def test_factor_matches_jax(n):
    a = _spd(np.random.default_rng(n), n, (4,))
    want = jax.vmap(jla.cholesky_factor)(jnp.asarray(a))
    got = tla.cholesky_factor(_t(a))
    _close(got, want, atol=2e-6 * np.sqrt(n))
    assert np.all(np.triu(got.numpy(), 1) == 0.0)


def test_factor_floors_an_indefinite_matrix():
    """A negative pivot is floored at 1e-12 (finite), where
    torch.linalg.cholesky raises."""
    a = np.diag([4.0, -1e-8, 9.0]).astype(np.float32)
    got = tla.cholesky_factor(_t(a))
    want = jla.cholesky_factor(jnp.asarray(a))
    _close(got, want, atol=0.0)
    assert np.all(np.isfinite(got.numpy()))
    with pytest.raises(Exception):
        torch.linalg.cholesky(_t(a))


def test_solve_spd_batched_34():
    rng = np.random.default_rng(5)
    a = _spd(rng, 34, (16,))
    b = rng.normal(size=(16, 34)).astype(np.float32)
    got = tla.solve_spd(_t(a), _t(b)).numpy()
    want = np.asarray(jax.vmap(jla.solve_spd)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    exact = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3 * np.abs(exact).max())
    # a factor reused for several right-hand sides (the Delassus rows)
    rhs = rng.normal(size=(16, 5, 34)).astype(np.float32)
    l_t = tla.cholesky_factor(_t(a))
    y = tla._solve_lower(l_t[:, None], _t(rhs)).numpy()
    y_j = jax.vmap(lambda l, r: jla._solve_lower(l, r))(jla.cholesky_factor(jnp.asarray(a)),
                                                         jnp.asarray(rhs))
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=0, atol=1e-5 * np.abs(y_j).max())
    x = tla.cholesky_solve(l_t, _t(b)).numpy()
    np.testing.assert_allclose(x, got, rtol=0, atol=0)


def test_solve_spd_gradient_matches_jax():
    rng = np.random.default_rng(4)
    a = _spd(rng, 6)
    b = rng.normal(size=(6,)).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda m: jnp.sum(jla.solve_spd(m, jnp.asarray(b)) ** 2))(
        jnp.asarray(a)))
    at = _t(a).requires_grad_(True)
    torch.sum(tla.solve_spd(at, _t(b)) ** 2).backward()
    g_t = at.grad.numpy()
    assert np.all(np.isfinite(g_t))
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())
