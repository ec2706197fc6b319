"""SMPL body-model fitting from 3-D joints (joints2smpl / SMPLify-3D).

The counterpart of `mmada_tpu/eval/smpl_fit.py` (the reference's
visualize/simplify_loc2rot.py:13-115, visualize/joints2smpl/src/smplify.py
:44-279, customloss.py:6-222, prior.py:97-229): recover SMPL pose and shape
(and a posed mesh) from generated HumanML3D joint positions, so that motions
render as meshes.

  * The SMPL forward (shape blendshapes, joint regression, forward
    kinematics, linear blend skinning) is one batched function over frames.
  * Both fitting stages (camera + orientation, then the full body) are
    plain torch loops under autograd, each step an Adam update rounded as
    optax's `adam` (the port's `training/optimizers.AdamW` with no decay
    and no clip).
  * The MPG-licensed SMPL assets cannot ship; `BodyModel.from_npz` loads
    them when present, and `synthetic_body_model()` is a deterministic
    low-poly humanoid with the same kinematic tree, so the whole pipeline
    runs without them (the fit's math is the same either way).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.training.optimizers import AdamW

# SMPL's kinematic tree (24 joints, the standard parents)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
NUM_SMPL_JOINTS = 24
# HumanML3D / AMASS use the first 22 SMPL joints (no hands; the reference's
# config.py: amass_idx = range(22))
AMASS_NUM_JOINTS = 22
# the torso joints of the camera's init and fit (config.py JOINT_MAP: RHip
# 2, LHip 1, RShoulder 17, LShoulder 16)
TORSO_IDX = (2, 1, 17, 16)
# the knee / elbow bends of the 69-dim body pose, with their signs
# (customloss.py:15-21: indices [55, 58, 12, 15] - 3 into body_pose)
ANGLE_PRIOR_IDX = (52, 55, 9, 12)
ANGLE_PRIOR_SIGNS = (1.0, -1.0, -1.0, -1.0)


# --------------------------------------------------------------------------
# rotations
# --------------------------------------------------------------------------

def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3). The norm is smoothed
    (sqrt(|aa|^2 + eps)) so that its gradient at the zero rotation, where
    the fit starts, is finite."""
    angle = torch.sqrt((aa * aa).sum(-1, keepdim=True) + 1e-16)
    axis = aa / angle
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    k = torch.stack([torch.stack([zero, -z, y], dim=-1),
                     torch.stack([z, zero, -x], dim=-1),
                     torch.stack([-y, x, zero], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    return eye + s * k + (1.0 - c) * (k @ k)


def matrix_to_rotation_6d(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows (pytorch3d's convention,
    the reference's rotation_conversions.py)."""
    return mat[..., :2, :].reshape(*mat.shape[:-2], 6)


# --------------------------------------------------------------------------
# the body model
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BodyModel:
    """A functional SMPL-style body model (LBS; pose blendshapes when the
    asset gives `posedirs`)."""

    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    j_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    faces: torch.Tensor         # (F, 3) int32
    posedirs: Optional[torch.Tensor] = None  # ((J - 1) * 9, V * 3) or None

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def to(self, device: DeviceLike) -> "BodyModel":
        device = resolve_device(device)
        return BodyModel(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    @classmethod
    def from_npz(cls, path: str, device: DeviceLike = None) -> "BodyModel":
        """A converted SMPL asset (the official pickle converted once with
        numpy: v_template / shapedirs / J_regressor / weights / f [/ posedirs])."""
        data = np.load(path)
        device = resolve_device(device)

        def f32(key):
            return torch.as_tensor(np.asarray(data[key], np.float32), device=device)

        return cls(v_template=f32("v_template"), shapedirs=f32("shapedirs"),
                   j_regressor=f32("J_regressor"), lbs_weights=f32("weights"),
                   faces=torch.as_tensor(np.asarray(data["f"], np.int32), device=device),
                   posedirs=f32("posedirs") if "posedirs" in data else None)


def body_forward_batch(model: BodyModel, betas: torch.Tensor,
                       pose_aa: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(vertices (B, V, 3), joints (B, J, 3)) from betas (B, n_betas) and
    axis-angle poses (B, J, 3), row 0 the global orientation: the shape
    blendshapes, the joint regression, forward kinematics, skinning."""
    v_shaped = model.v_template + torch.einsum("vdb,nb->nvd", model.shapedirs, betas)
    j_rest = torch.einsum("jv,nvd->njd", model.j_regressor, v_shaped)      # (B, J, 3)
    rots = axis_angle_to_matrix(pose_aa)                                     # (B, J, 3, 3)
    if model.posedirs is not None:
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_feat = (rots[:, 1:] - eye).reshape(rots.shape[0], -1)
        v_shaped = v_shaped + (pose_feat @ model.posedirs).reshape(v_shaped.shape)
    # forward kinematics: a parent precedes its children in SMPL's tree
    world_rot = [rots[:, 0]]
    world_pos = [j_rest[:, 0]]
    for j in range(1, model.num_joints):
        p = SMPL_PARENTS[j]
        world_rot.append(world_rot[p] @ rots[:, j])
        bone = (j_rest[:, j] - j_rest[:, p])[..., None]
        world_pos.append(world_pos[p] + (world_rot[p] @ bone)[..., 0])
    r = torch.stack(world_rot, dim=1)                                         # (B, J, 3, 3)
    t = torch.stack(world_pos, dim=1)                                         # (B, J, 3)
    # skinning: x' = sum_j w_j (R_j (x - j_rest_j) + t_j)
    rel = v_shaped[:, None] - j_rest[:, :, None]                              # (B, J, V, 3)
    posed = torch.einsum("njab,njvb->njva", r, rel) + t[:, :, None]
    vertices = torch.einsum("vj,njva->nva", model.lbs_weights, posed)
    return vertices, t


def body_forward(model: BodyModel, betas: torch.Tensor,
                 pose_aa: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One body: (vertices (V, 3), joints (J, 3)) from betas (n_betas,) and
    pose (J, 3)."""
    v, j = body_forward_batch(model, betas[None], pose_aa[None])
    return v[0], j[0]


def synthetic_body_model(seed: int = 0, device: DeviceLike = None) -> BodyModel:
    """A deterministic low-poly humanoid with SMPL's kinematic tree: one
    small octahedron of 6 vertices rigidly bound to each joint, a joint
    regressor that averages them back (exact), and 3 shape modes (global
    scale, height, width); the JAX package's, vertex for vertex."""
    rest = np.zeros((NUM_SMPL_JOINTS, 3), np.float32)
    # a crude humanoid's rest pose (y up): hips at the origin
    rest[1], rest[2] = (0.1, -0.05, 0), (-0.1, -0.05, 0)        # L/R hip
    rest[4], rest[5] = (0.1, -0.45, 0), (-0.1, -0.45, 0)        # knees
    rest[7], rest[8] = (0.1, -0.85, 0), (-0.1, -0.85, 0)        # ankles
    rest[10], rest[11] = (0.1, -0.95, 0.1), (-0.1, -0.95, 0.1)  # feet
    rest[3] = (0, 0.15, 0)                                       # spine1
    rest[6] = (0, 0.3, 0)                                        # spine2
    rest[9] = (0, 0.45, 0)                                       # spine3
    rest[12] = (0, 0.6, 0)                                       # neck
    rest[15] = (0, 0.72, 0)                                      # head
    rest[13], rest[14] = (0.08, 0.52, 0), (-0.08, 0.52, 0)       # collars
    rest[16], rest[17] = (0.2, 0.5, 0), (-0.2, 0.5, 0)           # shoulders
    rest[18], rest[19] = (0.45, 0.5, 0), (-0.45, 0.5, 0)         # elbows
    rest[20], rest[21] = (0.7, 0.5, 0), (-0.7, 0.5, 0)           # wrists
    rest[22], rest[23] = (0.78, 0.5, 0), (-0.78, 0.5, 0)         # hands
    octa = 0.03 * np.array([(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                            (0, 0, -1)], np.float32)
    octa_faces = np.array([(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5), (1, 2, 5),
                           (3, 1, 5), (0, 3, 5)], np.int64)
    n_v = NUM_SMPL_JOINTS * 6
    v_template = (rest[:, None, :] + octa[None, :, :]).reshape(n_v, 3)
    faces = np.concatenate([octa_faces + 6 * j for j in range(NUM_SMPL_JOINTS)])
    weights = np.zeros((n_v, NUM_SMPL_JOINTS), np.float32)
    jreg = np.zeros((NUM_SMPL_JOINTS, n_v), np.float32)
    for j in range(NUM_SMPL_JOINTS):
        weights[6 * j: 6 * j + 6, j] = 1.0
        jreg[j, 6 * j: 6 * j + 6] = 1.0 / 6.0
    shapedirs = np.zeros((n_v, 3, 3), np.float32)
    shapedirs[:, :, 0] = 0.1 * v_template                    # global scale
    shapedirs[:, 1, 1] = 0.1 * v_template[:, 1]              # height
    shapedirs[:, 0, 2] = 0.1 * v_template[:, 0]              # width
    device = resolve_device(device)
    return BodyModel(v_template=torch.as_tensor(v_template, device=device),
                     shapedirs=torch.as_tensor(shapedirs, device=device),
                     j_regressor=torch.as_tensor(jreg, device=device),
                     lbs_weights=torch.as_tensor(weights, device=device),
                     faces=torch.as_tensor(faces.astype(np.int32), device=device))


# --------------------------------------------------------------------------
# priors and losses (customloss.py / prior.py)
# --------------------------------------------------------------------------

def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """The Geman-McClure robust error (customloss.py:6-12)."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Penalizes unnatural knee / elbow bends (customloss.py:15-21);
    body_pose (B, 69)."""
    signs = torch.tensor(ANGLE_PRIOR_SIGNS, dtype=body_pose.dtype, device=body_pose.device)
    return torch.exp(body_pose[:, list(ANGLE_PRIOR_IDX)] * signs) ** 2


@dataclasses.dataclass
class GMMPrior:
    """The max-mixture Gaussian pose prior (prior.py:97-229): the SMPLify
    gmm_08 arrays when the asset is present; `l2_prior` is the fallback
    with the same call."""

    means: torch.Tensor        # (N, 69)
    precisions: torch.Tensor   # (N, 69, 69)
    weights: torch.Tensor      # (N,) nll weights, merged with the covariances' dets

    @classmethod
    def from_arrays(cls, means: np.ndarray, covars: np.ndarray, weights: np.ndarray,
                    device: DeviceLike = None) -> "GMMPrior":
        """From SMPLify's gmm_08 fields (means / covars / weights), with the
        reference's merged nll weights (prior.py:145-159):
        w / ((2 pi)^(D/2) sqrt(det S) / min sqrt(det S))."""
        precisions = np.stack([np.linalg.inv(c) for c in covars])
        sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covars])
        const = (2 * np.pi) ** (means.shape[1] / 2.0)
        nll_weights = weights / (const * (sqrdets / sqrdets.min()))
        return cls._f32(means, precisions, nll_weights, device)

    @classmethod
    def from_npz(cls, path: str, device: DeviceLike = None) -> "GMMPrior":
        d = np.load(path)
        if "covars" in d:  # SMPLify's own fields
            return cls.from_arrays(d["means"], d["covars"], d["weights"], device)
        return cls._f32(d["means"], d["precisions"], d["weights"], device)

    @classmethod
    def _f32(cls, means, precisions, weights, device) -> "GMMPrior":
        device = resolve_device(device)
        return cls(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                     for a in (means, precisions, weights)))

    def __call__(self, body_pose: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
        diff = body_pose[:, None, :] - self.means[None]            # (B, N, 69)
        maha = 0.5 * torch.einsum("bni,nij,bnj->bn", diff, self.precisions, diff)
        # the min over components of (mahalanobis - log weight): the
        # reference's "max mixture" (prior.py's merged log-likelihood)
        return (maha + (-torch.log(self.weights))[None]).min(dim=-1).values


def l2_prior(body_pose: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """L2Prior (prior.py:91-96), the fallback without the GMM asset."""
    return (body_pose ** 2).sum(-1)


def camera_fitting_loss_3d(model_joints, camera_t, camera_t_est, j3d,
                           depth_loss_weight: float = 100.0) -> torch.Tensor:
    """The torso's alignment and the depth anchor (customloss.py:192-222,
    AMASS: the same indices on both sides). The reference's quirk is kept:
    `j3d_error_loss + depth_loss` broadcasts the (B, 1, 3) depth term
    against the (B, 4, 3) torso error before the sum, weighting the anchor
    4x."""
    cam = camera_t.reshape(camera_t.shape[0], 1, 3)
    moved = model_joints + cam
    idx = list(TORSO_IDX)
    j3d_err = (j3d[:, idx] - moved[:, idx]) ** 2
    depth = (depth_loss_weight ** 2) * (cam - camera_t_est.reshape(cam.shape)) ** 2
    return (j3d_err + depth).sum()


def body_fitting_loss_3d(body_pose, preserve_pose, betas, model_joints, camera_t, j3d,
                         pose_prior, joints3d_conf=1.0, sigma: float = 100.0,
                         pose_prior_weight: float = 4.78 * 1.5, shape_prior_weight: float = 5.0,
                         angle_prior_weight: float = 15.2, joint_loss_weight: float = 500.0,
                         pose_preserve_weight: float = 0.0) -> torch.Tensor:
    """The full SMPLify-3D objective (customloss.py:128-188)."""
    cam = camera_t.reshape(camera_t.shape[0], 1, 3)
    err = gmof((model_joints + cam) - j3d, sigma)
    joint_loss = (joints3d_conf ** 2) * err.sum(-1)
    joint_loss = ((joint_loss_weight ** 2) * joint_loss).sum(-1)
    prior_loss = (pose_prior_weight ** 2) * pose_prior(body_pose, betas)
    ang_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(-1)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    preserve = (pose_preserve_weight ** 2) * ((body_pose - preserve_pose) ** 2).sum(-1)
    return (joint_loss + prior_loss + ang_loss + shape_loss + preserve).sum()


# --------------------------------------------------------------------------
# SMPLify-3D
# --------------------------------------------------------------------------

def guess_init_3d(model_joints: torch.Tensor, j3d: torch.Tensor) -> torch.Tensor:
    """The camera translation's init from the torso's correspondence
    (smplify.py:18-40, AMASS)."""
    idx = list(TORSO_IDX)
    return (j3d[:, idx] - model_joints[:, idx]).sum(dim=1) / 4.0


@dataclasses.dataclass
class SMPLifyConfig:
    step_size: float = 1e-2
    num_iters: int = 150          # the body stage (simplify_loc2rot.py:21)
    camera_iters: int = 20        # the reference's Adam branch (smplify.py:187)
    joint_loss_weight: float = 600.0
    pose_preserve_weight: float = 5.0
    num_fit_joints: int = AMASS_NUM_JOINTS


def _adam_fit(loss_fn, params: dict, lr: float, iters: int) -> dict:
    """`iters` Adam steps (optax.adam's rounding: the port's AdamW without
    decay or clip) on the leaves of `params`, from their values."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = AdamW(lr, beta1=0.9, beta2=0.999, weight_decay=0.0, max_grad_norm=None,
                no_decay_keys=())
    state = opt.init(p)
    names = list(p)
    for _ in range(iters):
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(p), [p[n] for n in names])
        opt.apply(p, dict(zip(names, grads)), state)
    return {k: v.detach() for k, v in p.items()}


def smplify3d(model: BodyModel, init_pose: torch.Tensor, init_betas: torch.Tensor,
              j3d: torch.Tensor, conf_3d=1.0, pose_prior=l2_prior,
              cfg: SMPLifyConfig = SMPLifyConfig()):
    """The two-stage SMPLify fit (smplify.py:95-279): camera + orientation,
    then the full body, each an Adam loop. init_pose (B, 72) axis-angle
    (the first 3 the global orientation), init_betas (B, n_betas), j3d
    (B, J_fit, 3). Returns (vertices, joints, pose, betas, camera_t,
    final_loss)."""
    nj = model.num_joints
    fit = cfg.num_fit_joints

    def fk(pose72, betas):
        return body_forward_batch(model, betas, pose72.reshape(-1, nj, 3))

    body_pose = init_pose[:, 3:]
    preserve_pose = init_pose[:, 3:]
    betas = init_betas
    _, joints0 = fk(init_pose, betas)
    cam_t = guess_init_3d(joints0, j3d)[:, None, :]   # (B, 1, 3)
    init_cam_t = cam_t

    # stage 1: the camera's translation and the global orientation
    def cam_loss(p):
        _, joints = fk(torch.cat([p["orient"], body_pose], dim=-1), betas)
        return camera_fitting_loss_3d(joints, p["cam"], init_cam_t, j3d)

    p1 = _adam_fit(cam_loss, {"orient": init_pose[:, :3], "cam": cam_t}, cfg.step_size,
                   cfg.camera_iters)

    # stage 2: the full body
    def body_loss(p):
        _, joints = fk(torch.cat([p["orient"], p["body"]], dim=-1), p["betas"])
        return body_fitting_loss_3d(
            p["body"], preserve_pose, p["betas"], joints[:, :fit], p["cam"], j3d, pose_prior,
            joints3d_conf=conf_3d, joint_loss_weight=cfg.joint_loss_weight,
            pose_preserve_weight=cfg.pose_preserve_weight)

    p2 = _adam_fit(body_loss, {"orient": p1["orient"], "body": body_pose, "betas": betas,
                               "cam": p1["cam"]}, cfg.step_size, cfg.num_iters)
    pose = torch.cat([p2["orient"], p2["body"]], dim=-1)
    verts, joints = fk(pose, p2["betas"])
    return verts, joints, pose, p2["betas"], p2["cam"], body_loss(p2)


@torch.no_grad()
def joints2smpl(joint_seq: np.ndarray, model: Optional[BodyModel] = None,
                pose_prior=l2_prior, cfg: Optional[SMPLifyConfig] = None,
                device: DeviceLike = None, info: Optional[dict] = None):
    """Fit a whole clip (simplify_loc2rot.py:63-114), a batch of frames, on
    `device` (the card unless told otherwise). joint_seq (T, 22, 3)
    HumanML3D joints. Returns (thetas (1, 25, 6, T): rot6d + the root
    translation's row, vertices (T, V, 3), betas), numpy; `info`, a dict,
    receives the fit's joints (T, J, 3), camera and final loss."""
    device = resolve_device(device)
    model = (model or synthetic_body_model(device=device)).to(device)
    cfg = cfg or SMPLifyConfig()
    t = joint_seq.shape[0]
    j3d = torch.as_tensor(np.asarray(joint_seq, np.float32), device=device)
    init_pose = torch.zeros((t, NUM_SMPL_JOINTS * 3), device=device)
    init_betas = torch.zeros((t, model.num_betas), device=device)
    verts, joints, pose, betas, cam, loss = smplify3d(model, init_pose, init_betas, j3d,
                                                      pose_prior=pose_prior, cfg=cfg)
    rot6d = matrix_to_rotation_6d(axis_angle_to_matrix(pose.reshape(t, NUM_SMPL_JOINTS, 3)))
    root = j3d[:, 0]                                                     # (T, 3)
    root6 = torch.cat([root, torch.zeros_like(root)], -1)[:, None]
    thetas = torch.cat([rot6d, root6], dim=1)[None].permute(0, 2, 3, 1)  # (1, 25, 6, T)
    if info is not None:
        info.update(joints=joints.cpu().numpy(), cam=cam.cpu().numpy(), loss=float(loss))
    return thetas.cpu().numpy(), verts.cpu().numpy(), betas.cpu().numpy()
