"""The port's SMPL fit (`mmada_tpu_torch/eval/smpl_fit.py`) against the JAX
package's `smpl_fit` and the reference's loss goldens
(`tests/goldens/smplify_losses.npz`, at `tests/test_smpl_fit.py`'s bars):
the synthetic body model and its forward, the priors and losses, and
`smplify3d` / `joints2smpl` (Adam in optax's rounding) on the same joints:
10 body iterations elementwise, 5 camera + 10 body iterations by the final
loss and the fit's error (the camera's first step follows rounding noise).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.eval import smpl_fit as J
from mmada_tpu_torch.eval import mesh_render, smpl_fit as P

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "smplify_losses.npz")
FIT = dict(camera_iters=5, num_iters=10)
BODY_STAGE = dict(camera_iters=0, num_iters=10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return P.synthetic_body_model(device="cpu"), J.synthetic_body_model()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_synthetic_body_model_equals_jax(models):
    port, jm = models
    for name in ("v_template", "shapedirs", "j_regressor", "lbs_weights", "faces"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)


def test_body_forward_matches_jax(models):
    """Posed vertices and joints of random poses and shapes, batched and one
    by one."""
    port, jm = models
    rng = np.random.default_rng(0)
    pose = rng.normal(scale=0.4, size=(3, 24, 3)).astype(np.float32)
    betas = rng.normal(scale=0.5, size=(3, 3)).astype(np.float32)
    v, j = P.body_forward_batch(port, _t(betas), _t(pose))
    jv, jj = J.body_forward_batch(jm, jnp.asarray(betas), jnp.asarray(pose))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-5, atol=1e-6)
    v0, j0 = P.body_forward(port, _t(betas[0]), _t(pose[0]))
    np.testing.assert_allclose(v0.numpy(), v[0].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(j0.numpy(), j[0].numpy(), rtol=1e-6, atol=1e-7)


def test_rotations_match_jax():
    rng = np.random.default_rng(1)
    aa = rng.normal(size=(10, 3)).astype(np.float32)
    aa[0] = 0.0
    r = P.axis_angle_to_matrix(_t(aa))
    np.testing.assert_allclose(r.numpy(), np.asarray(J.axis_angle_to_matrix(jnp.asarray(aa))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(P.matrix_to_rotation_6d(r).numpy(),
                                  np.asarray(J.matrix_to_rotation_6d(jnp.asarray(r.numpy()))))


def test_gmof_and_angle_prior_golden():
    g = dict(np.load(GOLDENS))
    np.testing.assert_allclose(P.gmof(_t(g["gmof_in"]), 100.0).numpy(), g["gmof"], rtol=1e-5)
    np.testing.assert_allclose(P.angle_prior(_t(g["body_pose"])).numpy(), g["angle_prior"],
                               rtol=1e-5)


def test_camera_fitting_loss_golden():
    g = dict(np.load(GOLDENS))
    got = P.camera_fitting_loss_3d(_t(g["model_joints"]), _t(g["cam"]), _t(g["cam_est"]),
                                   _t(g["j3d"]))
    np.testing.assert_allclose(float(got), g["camera_loss"], rtol=1e-4)


def test_gmm_prior_golden():
    g = dict(np.load(GOLDENS))
    prior = P.GMMPrior.from_arrays(g["gmm_means"], g["gmm_covars"], g["gmm_weights"],
                                   device="cpu")
    got = prior(_t(g["body_pose"]), torch.zeros((2, 10))).numpy()
    np.testing.assert_allclose(got, g["gmm_nll"], rtol=2e-4, atol=2e-4)


def test_body_fitting_loss_golden():
    g = dict(np.load(GOLDENS))
    prior = P.GMMPrior.from_arrays(g["gmm_means"], g["gmm_covars"], g["gmm_weights"],
                                   device="cpu")
    got = P.body_fitting_loss_3d(
        _t(g["body_pose"]), _t(g["preserve_pose"]), _t(g["betas"]), _t(g["model_joints"]),
        _t(g["cam"]), _t(g["j3d"]), prior, joints3d_conf=torch.ones(22),
        joint_loss_weight=600.0, pose_preserve_weight=5.0)
    np.testing.assert_allclose(float(got), g["body_loss"], rtol=1e-4)


def _target(jm, seed=3, frames=4):
    """Joints of known poses moved by a camera (`test_smpl_fit.py`'s setup,
    with the root and the spine bent too: with the torso at rest its
    residuals after the camera's init are zero up to rounding, and Adam's
    first step, the sign of the gradient, would follow the rounding)."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((frames, 72), np.float32)
    for j in (0, 1, 2, 3, 4, 6, 9, 16, 17, 18):
        pose[:, 3 * j: 3 * j + 3] = rng.normal(scale=0.25, size=(frames, 3))
    cam = rng.normal(scale=0.1, size=(frames, 3)).astype(np.float32)
    _, joints = J.body_forward_batch(jm, jnp.zeros((frames, 3)),
                                     jnp.asarray(pose).reshape(frames, 24, 3))
    return np.asarray(joints[:, :22]) + cam[:, None]


def _priors(prior):
    if prior == "l2":
        return P.l2_prior, J.l2_prior
    rng = np.random.default_rng(7)
    means = rng.normal(scale=0.1, size=(3, 69))
    a = rng.normal(scale=0.3, size=(3, 69, 69))
    covars = a @ a.transpose(0, 2, 1) + np.eye(69)
    weights = np.array([0.5, 0.3, 0.2])
    return (P.GMMPrior.from_arrays(means, covars, weights, device="cpu"),
            J.GMMPrior.from_arrays(means, covars, weights))


@pytest.fixture(scope="module")
def jax_fits():
    """JAX's fits by (prior, iterations), each made once (every call of its
    `smplify3d` compiles both stages anew)."""
    return {}


def _fits(models, jax_fits, prior, **fit):
    port, jm = models
    j3d = _target(jm)
    n = j3d.shape[0]
    pp, jp = _priors(prior)
    got = P.smplify3d(port, torch.zeros((n, 72)), torch.zeros((n, 3)), _t(j3d), pose_prior=pp,
                      cfg=P.SMPLifyConfig(**fit))
    key = (prior, tuple(sorted(fit.items())))
    if key not in jax_fits:
        jax_fits[key] = [np.asarray(w) for w in J.smplify3d(
            jm, jnp.zeros((n, 72)), jnp.zeros((n, 3)), jnp.asarray(j3d), pose_prior=jp,
            cfg=J.SMPLifyConfig(**fit))]
    return j3d, [np.asarray(g) for g in got], jax_fits[key]


@pytest.mark.parametrize("prior", ["l2", "gmm"])
def test_smplify3d_body_stage_matches_jax(models, jax_fits, prior):
    """10 body-stage Adam steps from the zero pose (no camera stage): the
    vertices, joints, pose, betas, camera and final loss against JAX's
    scanned optax fit."""
    _, got, want = _fits(models, jax_fits, prior, **BODY_STAGE)
    names = ("vertices", "joints", "pose", "betas", "camera", "loss")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("prior", ["l2", "gmm"])
def test_smplify3d_both_stages_match_jax(models, jax_fits, prior):
    """5 camera + 10 body steps: the final loss and the fit's joint RMSE
    within 1% of JAX's. Elementwise the fits part: the camera's init
    (`guess_init_3d`) zeroes the camera's own gradient (its torso residuals
    sum to zero), so Adam's first camera step, the sign of that gradient,
    is the sign of rounding noise in each package (+-step_size); the body
    stage alone is held elementwise above."""
    j3d, got, want = _fits(models, jax_fits, prior, **FIT)
    n = j3d.shape[0]

    def rmse(out):
        return np.sqrt(np.mean((out[1][:, :22] + out[4].reshape(n, 1, 3) - j3d) ** 2))

    np.testing.assert_allclose(got[5], want[5], rtol=1e-2)
    np.testing.assert_allclose(rmse(got), rmse(want), rtol=1e-2)
    assert rmse(got) < np.sqrt(np.mean((j3d - j3d.mean(axis=1, keepdims=True)) ** 2))


def test_joints2smpl_matches_jax_and_exports(models, jax_fits, tmp_path):
    """The clip wrapper on the body stage's joints: thetas (1, 25, 6, T)
    (rot6d + the root's row), vertices and betas against JAX's fit of the
    same joints (`joints2smpl`'s own steps, computed here); the fit's info;
    the OBJ export of the port's copy."""
    port, jm = models
    j3d, _, want = _fits(models, jax_fits, "l2", **BODY_STAGE)
    n = j3d.shape[0]
    info = {}
    thetas, verts, betas = P.joints2smpl(j3d, model=port, cfg=P.SMPLifyConfig(**BODY_STAGE),
                                         device="cpu", info=info)
    rot6d = J.matrix_to_rotation_6d(J.axis_angle_to_matrix(jnp.asarray(want[2]).reshape(n, 24, 3)))
    root6 = np.concatenate([j3d[:, 0], np.zeros_like(j3d[:, 0])], -1)[:, None]
    want_thetas = np.concatenate([np.asarray(rot6d), root6], 1)[None].transpose(0, 2, 3, 1)
    assert thetas.shape == (1, 25, 6, n) and verts.shape == (n, 144, 3)
    for g, w in ((thetas, want_thetas), (verts, want[0]), (betas, want[3])):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)
    assert info["joints"].shape == (n, 24, 3) and np.isfinite(info["loss"])
    paths = mesh_render.save_obj_sequence(str(tmp_path / "objs"), verts, port.faces.numpy())
    assert len(paths) == n
    first = open(paths[0]).read().splitlines()
    assert first[0].startswith("v ") and any(ln.startswith("f ") for ln in first)
    assert jax.devices()[0].platform == "cpu"
