"""Fit SMPL meshes to motion joints and export OBJ frames + a GIF, on the card.

The PyTorch port's counterpart of `tools/render_motion_mesh.py` (the
reference's visualize/render_mesh.py + visualize/simplify_loc2rot.py
npy2smpl): takes a (T, 22, 3) HumanML3D joints .npy (for example
`eval.motion_math.recover_from_ric` of a t2m generation), runs the
SMPLify-3D fit (`eval.smpl_fit.joints2smpl`), and writes
`objs/frame{i:03d}.obj`, the fitted thetas (`smpl_thetas.npy`: rot6d, the
reference's [1, 25, 6, T] layout) and a rendered `mesh.gif`
(`eval.mesh_render`).

    python tools/render_motion_mesh_torch.py input=joints.npy out_dir=out \\
        [smpl_npz=/mnt/smpl_neutral.npz] [gmm_npz=/mnt/gmm_08.npz] \\
        [num_iters=150] [sample=0] [rep=0] [device=cpu]

`input` is a raw (T, 22, 3) joints array or an MDM-style `results.npy` dict
({'motion': (N, J, 3, T), 'lengths', 'num_samples'}; a clip picked with
sample= / rep=). Without `smpl_npz` the deterministic synthetic body model
is used (the SMPL asset is licensed and does not ship). One key more than
`tools/render_motion_mesh.py`: `device` (the card unless `device=cpu`).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def load_joints(args):
    """The raw (T, J, 3) array, or clip `rep * num_samples + sample` of an
    MDM results.npy dict (vis_utils.npy2obj's indexing), cut to its length."""
    import numpy as np

    raw = np.load(args["input"], allow_pickle=True)
    if raw.dtype != object:
        return raw
    motions = raw[None][0]
    index = int(args.get("rep", 0)) * int(motions.get("num_samples", 1)) + int(
        args.get("sample", 0))
    clip = np.asarray(motions["motion"][index])      # (J, 3, T)
    if clip.ndim != 3 or clip.shape[1] != 3:
        raise ValueError(f"expected (J, 3, T) motion, got {clip.shape}")
    joints = clip.transpose(2, 0, 1)                 # (T, J, 3)
    lengths = motions.get("lengths")
    if lengths is not None:
        joints = joints[: int(np.asarray(lengths).reshape(-1)[index])]
    return joints


def render(args: dict) -> dict:
    """Fit and write everything `args` asks for; returns the fit's `info`
    (joints, camera, loss) with the written paths under "objs" and "gif"."""
    import numpy as np

    from mmada_tpu_torch.core.device import resolve_device
    from mmada_tpu_torch.eval import mesh_render, smpl_fit

    device = resolve_device(args.get("device"))
    joints = load_joints(args)
    if joints.ndim != 3 or joints.shape[-1] != 3:
        raise ValueError(f"expected (T, J, 3) joints, got {joints.shape}")
    joints = joints[:, : smpl_fit.AMASS_NUM_JOINTS]
    model = (smpl_fit.BodyModel.from_npz(args["smpl_npz"], device=device)
             if args.get("smpl_npz") else smpl_fit.synthetic_body_model(device=device))
    prior = (smpl_fit.GMMPrior.from_npz(args["gmm_npz"], device=device)
             if args.get("gmm_npz") else smpl_fit.l2_prior)
    cfg = smpl_fit.SMPLifyConfig(num_iters=int(args.get("num_iters", 150)))
    info: dict = {}
    thetas, verts, _ = smpl_fit.joints2smpl(joints, model=model, pose_prior=prior, cfg=cfg,
                                            device=device, info=info)
    out_dir = args.get("out_dir", "mesh_out")
    os.makedirs(out_dir, exist_ok=True)
    faces = model.faces.cpu().numpy()
    info["objs"] = mesh_render.save_obj_sequence(os.path.join(out_dir, "objs"), verts, faces)
    np.save(os.path.join(out_dir, "smpl_thetas.npy"), thetas)
    info["gif"] = mesh_render.render_mesh_frames(verts, faces, os.path.join(out_dir, "mesh.gif"))
    return info


def main(argv) -> int:
    info = render(dict(kv.split("=", 1) for kv in argv if "=" in kv))
    print(f"wrote {len(info['objs'])} obj frames, smpl_thetas.npy, {info['gif']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
