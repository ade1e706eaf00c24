"""Parity of the port's Lie-group functions (startrax_torch.ops.lie) with
startrax.ops.lie, and the cases of tests/test_lie.py on the port.

Inputs are float32 numpy arrays made from a seed, on the CPU. Each function
is held to its JAX counterpart on a random batch within 1e-5 (absolute and
relative), the small-angle cases included. The golden cases keep
test_lie.py's tolerances (1e-5 against scipy, 1e-4 for the exp/log round
trips). The gradients at the zero tangent
and the identity rotation must be finite, and a pose must be recoverable by
gradient descent, as tests/test_lie.py::test_pose_recovery_by_gradient_descent
shows for the JAX side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from startrax.ops import lie as jlie
from startrax_torch.ops import lie as tlie

TOL = dict(rtol=1e-5, atol=1e-5)


def _quats(n, seed):
    r = Rotation.random(n, random_state=seed)
    return r.as_quat().astype(np.float32), r


def _poses(n, seed):
    q, _ = _quats(n, seed)
    t = np.random.default_rng(seed + 100).normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([t, q], axis=-1)


def _tangents(n, seed, scale=0.8):
    tau = (np.random.default_rng(seed).normal(size=(n, 6)) * scale).astype(np.float32)
    tau[0] = 0.0  # the small-angle branches
    tau[1, 3:] = 1e-6
    return tau


def _matrices(n, seed):
    return _quats(n, seed)[1].as_matrix().astype(np.float32).reshape(n // 4, 4, 3, 3)


# each case: (function name, inputs as float32 numpy arrays)
CASES = {
    "_safe_norm": lambda: (np.concatenate([np.zeros((2, 3)), np.random.default_rng(0).normal(
        size=(14, 3))]).astype(np.float32),),
    "quat_conjugate": lambda: (_quats(16, 1)[0],),
    "matrix_to_quat": lambda: (_matrices(32, 2),),
    "so3_exp": lambda: (_tangents(32, 3)[:, 3:],),
    "so3_log": lambda: (_quats(32, 4)[0],),
    "se3_inverse": lambda: (_poses(16, 5),),
    "_so3_left_jacobian": lambda: (_tangents(32, 6)[:, 3:],),
    "se3_exp": lambda: (_tangents(32, 7),),
    "se3_log": lambda: (_poses(32, 8),),
    "se3_to_matrix": lambda: (_poses(16, 9).reshape(4, 4, 7),),
    "matrix_to_se3": lambda: (np.array(jlie.se3_to_matrix(jnp.asarray(_poses(16, 10)))),),
    "rotation_metric": lambda: (_matrices(16, 11)[0], _matrices(16, 12)[0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_function_matches_startrax(name):
    inputs = CASES[name]()
    got = getattr(tlie, name)(*(torch.from_numpy(a) for a in inputs)).numpy()
    want = np.asarray(getattr(jlie, name)(*(jnp.asarray(a) for a in inputs)))
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_quat_conjugate_and_se3_inverse_compose_to_identity():
    pose = torch.from_numpy(_poses(8, 12))
    ident = tlie.se3_multiply(pose, tlie.se3_inverse(pose))
    np.testing.assert_allclose(ident[..., :3].numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(ident[..., 6].abs().numpy(), 1.0, atol=1e-5)
    q = pose[..., 3:]
    np.testing.assert_allclose(tlie.quat_multiply(q, tlie.quat_conjugate(q)).numpy(),
                               np.tile([0, 0, 0, 1], (8, 1)), atol=1e-6)


def test_matrix_to_quat_roundtrip_and_canonical_sign():
    q, r = _quats(64, 3)
    q2 = tlie.matrix_to_quat(torch.from_numpy(r.as_matrix().astype(np.float32))).numpy()
    np.testing.assert_allclose(np.abs(np.sum(q * q2, axis=-1)), 1.0, atol=1e-5)
    assert (q2[:, 3] >= 0).all()


def test_so3_exp_log_roundtrip_and_scipy():
    rng = np.random.default_rng(6)
    phi = rng.normal(size=(32, 3)).astype(np.float32)
    phi[0] = 0.0
    phi[1] = 1e-6
    q = tlie.so3_exp(torch.from_numpy(phi))
    np.testing.assert_allclose(tlie.so3_log(q).numpy(), phi, atol=1e-4)
    want = Rotation.from_rotvec(phi).as_quat().astype(np.float32)
    np.testing.assert_allclose(np.abs(np.sum(q.numpy() * want, axis=-1)), 1.0, atol=1e-5)


def test_se3_exp_log_roundtrip():
    tau = _tangents(32, 11)
    pose = tlie.se3_exp(torch.from_numpy(tau))
    np.testing.assert_allclose(tlie.se3_log(pose).numpy(), tau, atol=1e-4)


def test_se3_matrix_roundtrip_acts_alike():
    pose = torch.from_numpy(_poses(8, 14))
    pose2 = tlie.matrix_to_se3(tlie.se3_to_matrix(pose))
    pts = torch.from_numpy(np.random.default_rng(16).normal(size=(8, 3)).astype(np.float32))
    np.testing.assert_allclose(tlie.se3_act(pose, pts).numpy(), tlie.se3_act(pose2, pts).numpy(),
                               atol=1e-5)
    T = tlie.se3_to_matrix(pose)
    want = np.einsum("nij,nj->ni", T[:, :3, :3].numpy(), pts.numpy()) + T[:, :3, 3].numpy()
    np.testing.assert_allclose(tlie.se3_act(pose, pts).numpy(), want, atol=1e-5)


def test_rotation_metric_known_values():
    R1 = torch.from_numpy(Rotation.from_euler("xyz", [[0.3, -0.2, 1.0]]).as_matrix()
                          .astype(np.float32))
    assert float(tlie.rotation_metric(R1, R1)[0]) < 1e-5
    R2 = torch.from_numpy(Rotation.from_euler("z", [np.pi]).as_matrix().astype(np.float32))
    got = float(tlie.rotation_metric(torch.eye(3)[None], R2)[0])
    np.testing.assert_allclose(got, np.sqrt(8.0), rtol=1e-5)


@pytest.mark.parametrize("name", ["_safe_norm", "so3_exp", "se3_exp", "so3_log", "se3_log"])
def test_grads_finite_at_zero_and_identity(name):
    """At the zero tangent and the identity rotation the Taylor branches
    are taken; torch.where still differentiates both branches, so the other
    one must not produce inf or NaN there."""
    x = {"_safe_norm": torch.zeros(2, 3), "so3_exp": torch.zeros(2, 3),
         "se3_exp": torch.zeros(2, 6), "so3_log": torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 2),
         "se3_log": tlie.se3_identity(2)}[name].requires_grad_(True)
    getattr(tlie, name)(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_pose_recovery_by_gradient_descent():
    """A learnable SE(3) tangent converges to a random GT pose by Adam on
    point-cloud MSE (the JAX side: tests/test_lie.py), starting from the
    zero tangent, with test_lie.py's optimizer (Adam, lr 1e-2, 500 steps)."""
    rng = np.random.default_rng(42)
    gt_pose = tlie.se3_exp(torch.from_numpy(rng.normal(size=(6,)).astype(np.float32) * 0.5))
    pts = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    target = tlie.se3_act(gt_pose, pts)
    tau = torch.zeros(6, requires_grad=True)
    opt = torch.optim.Adam([tau], lr=1e-2)
    for _ in range(500):
        opt.zero_grad()
        loss = torch.mean((tlie.se3_act(tlie.se3_exp(tau), pts) - target) ** 2)
        loss.backward()
        assert torch.isfinite(tau.grad).all()
        opt.step()
    assert float(loss.detach()) < 1e-6
    est = tlie.se3_exp(tau.detach())
    np.testing.assert_allclose(est[:3].numpy(), gt_pose[:3].numpy(), atol=1e-3)
    np.testing.assert_allclose(abs(float(torch.dot(est[3:], gt_pose[3:]))), 1.0, atol=1e-5)
