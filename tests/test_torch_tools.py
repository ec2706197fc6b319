"""The port's tools (`tools/*_torch.py`) against the JAX package's, on the CPU.

* `tokenize_motions_torch` against `tools/tokenize_motions.py` on a tiny bank
  of HumanML3D-layout clips (one shorter than the VQ's stride), the same
  motion VQ-VAE weights in both (JAX's init tree filled from a seed,
  carried over by `motion_vq_from_jax` and saved by `save_params_only`):
  the same files, the same codes.
* `export_checkpoint_torch` on a 2-step `train_torch` run with the EMA on:
  the exported train params and the exported EMA shadow load back through
  `load_pretrained` equal to the trainer's, bit for bit; a run without the
  EMA refuses `ema=true`.
* `render_motion_mesh_torch` against `tools/render_motion_mesh.py` on a clip
  of an MDM-style results.npy: the port's fit (`joints2smpl`, 2 body
  iterations) handed to JAX's tool in place of JAX's (whose fit,
  compiled anew at every call, takes 5-28 s here; `test_torch_eval_smpl.py`
  holds the two fits against each other): the same joints, prior and
  iterations reach both fits, and both tools write the same thetas and OBJ
  frames, byte for byte.
* `motion_soak_torch`'s four stages in process at 2 steps each on tiny
  widths: the report's stages, the token bank, the report under the
  workdir, and the refusal to write the JAX rounds' report.
* None of the four imports jax or the JAX package.
"""

import dataclasses
import json
import os
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

import mmada_tpu.eval.smpl_fit as jax_smpl_fit
import mmada_tpu.models.motion_vq as jax_motion_vq
import train_torch
from mmada_tpu_torch.checkpoints.from_jax import motion_vq_from_jax
from mmada_tpu_torch.checkpoints.hf_import import load_pretrained
from mmada_tpu_torch.checkpoints.manager import flatten, save_params_only
from mmada_tpu_torch.eval import smpl_fit
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.motion_vq import tiny_motion_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import export_checkpoint_torch  # noqa: E402
import motion_soak_torch  # noqa: E402
import render_motion_mesh  # noqa: E402
import render_motion_mesh_torch  # noqa: E402
import tokenize_motions  # noqa: E402
import tokenize_motions_torch  # noqa: E402

TOOLS = ("tokenize_motions_torch.py", "motion_soak_torch.py", "export_checkpoint_torch.py",
         "render_motion_mesh_torch.py")
TINY = "configs/tiny_test.yaml"
TINY_VQ = [f"model.motion_vq_model.{k}={getattr(tiny_motion_cfg(), k)}"
           for k in ("pose_dim", "code_dim", "nb_code", "width", "down_t", "depth",
                     "dilation_growth_rate")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tokenize_motions_torch_writes_jax_codes(tmp_path, monkeypatch):
    # one residual block a level: JAX compiles the encoder in a second
    mcfg = dataclasses.replace(tiny_motion_cfg(), depth=1)
    rng = np.random.default_rng(0)
    root = tmp_path / "hml"
    (root / "new_joint_vecs").mkdir(parents=True)
    names = ["a", "short", "b"]   # one length (JAX compiles the encoder once a length)
    for name, frames in zip(names, (26, 3, 25)):
        np.save(root / "new_joint_vecs" / f"{name}.npy",
                rng.normal(size=(frames, mcfg.pose_dim)).astype(np.float32))
    np.save(root / "Mean.npy", rng.normal(size=mcfg.pose_dim).astype(np.float32) * 0.1)
    np.save(root / "Std.npy", (1 + rng.random(mcfg.pose_dim)).astype(np.float32))
    (root / "split.txt").write_text("\n".join(names) + "\n")

    init = jax_motion_vq.init_motion_vq
    made = {}

    def seeded(key, cfg):
        """JAX's init tree with seeded values (made without compiling the
        init; an EMA codebook would be zeros until trained)."""
        shapes = jax.eval_shape(lambda k: init(k, cfg), key)
        params = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32), shapes)
        params["codebook"] *= 0.5
        made["params"] = params
        return params

    monkeypatch.setattr(jax_motion_vq, "init_motion_vq", seeded)
    # JAX's tool imports its Orbax loader, which it calls only on a checkpoint
    # (importing Orbax alone takes about 9 s here)
    monkeypatch.setitem(sys.modules, "mmada_tpu.checkpoints.manager",
                        types.SimpleNamespace(load_params_only=None))
    common = [f"dataset.motion_root={root}", f"dataset.split_file={root / 'split.txt'}",
              *(f"model.motion_vq_model.{k}={getattr(mcfg, k)}" for k in (
                  "pose_dim", "code_dim", "nb_code", "width", "down_t", "depth",
                  "dilation_growth_rate"))]
    assert tokenize_motions.main(common + ["out_name=jax"]) == 0
    ckpt = save_params_only(str(tmp_path / "vq"), motion_vq_from_jax(made["params"], mcfg,
                                                                      device="cpu"))
    assert tokenize_motions_torch.main(
        common + ["out_name=port", "device=cpu", f"model.motion_vq_model.pretrained_path={ckpt}"]) == 0
    want = sorted(os.listdir(root / "jax"))
    assert want == ["a.npy", "b.npy"] and sorted(os.listdir(root / "port")) == want
    for f in want:
        a, b = np.load(root / "jax" / f), np.load(root / "port" / f)
        assert a.dtype == b.dtype and len(set(b.tolist())) > 1
        np.testing.assert_array_equal(b, a)


def _train(out, *extra):
    return train_torch.run(train_torch.read_config([
        f"config={TINY}", "device=cpu", "dataset.synthetic=true", "training.max_train_steps=2",
        "experiment.save_every=1", f"experiment.output_dir={out}",
        "model.mmada.num_vq_tokens=16", "dataset.preprocessing.resolution=16", *extra]))


def test_export_checkpoint_torch_round_trips(tmp_path):
    trainer = _train(tmp_path / "run", "training.ema.enabled=true")
    common = [f"config={TINY}", "device=cpu", f"checkpoint_dir={tmp_path / 'run'}",
              "model.mmada.num_vq_tokens=16", "dataset.preprocessing.resolution=16"]
    for ema, tree in ((False, trainer.state.params), (True, trainer.ema_state.shadow)):
        out = tmp_path / ("ema" if ema else "train")
        assert export_checkpoint_torch.main(common + [f"out_dir={out}", f"ema={ema}"]) == 0
        assert (out / "config.json").exists()
        got = load_pretrained(str(out), trainer.model.cfg, device="cpu", dtype=torch.float32)
        want = dict(llada.named_leaves(tree))
        named = dict(llada.named_leaves(got))
        assert sorted(named) == sorted(want)
        for k, t in want.items():
            torch.testing.assert_close(named[k], t.detach(), rtol=0, atol=0, msg=k)
    ema, train = (flatten(load_pretrained(str(tmp_path / d), trainer.model.cfg, device="cpu",
                                          dtype=torch.float32)) for d in ("ema", "train"))
    assert any(not torch.equal(ema[k], train[k]) for k in ema)
    # step=1 reads checkpoint-1; a run without the EMA has no shadow to export
    assert export_checkpoint_torch.main(common + [f"out_dir={tmp_path / 's1'}", "step=1"]) == 0
    _train(tmp_path / "plain")
    with pytest.raises(ValueError, match="ema.enabled"):
        export_checkpoint_torch.export(train_torch.read_config(
            [f"config={TINY}", "device=cpu", f"checkpoint_dir={tmp_path / 'plain'}", "ema=true",
             "model.mmada.num_vq_tokens=16", "dataset.preprocessing.resolution=16"]))


def test_render_motion_mesh_torch_against_jax(tmp_path, monkeypatch):
    """Both tools on one clip of an MDM-style results.npy (the second rep,
    its length cut): the port's tool fits it with `joints2smpl` (its output
    equal to a direct call's); JAX's tool, its fit replaced by that same
    fit (its arguments checked: the same joints, prior and iterations),
    writes the same thetas and OBJ frames, byte for byte."""
    body = smpl_fit.synthetic_body_model(device="cpu")
    rng = np.random.default_rng(3)
    pose = torch.zeros(6, 72)
    for j in (0, 1, 2, 3, 4, 6, 9, 16, 17, 18):
        pose[:, 3 * j: 3 * j + 3] = torch.as_tensor(rng.normal(scale=0.25, size=(6, 3)))
    _, joints = smpl_fit.body_forward_batch(body, torch.zeros(6, 3), pose.reshape(6, 24, 3))
    clips = joints.numpy().reshape(2, 3, 24, 3).transpose(0, 2, 3, 1)   # (N, J, 3, T)
    np.save(tmp_path / "results.npy", {"motion": clips, "lengths": np.array([3, 2]),
                                       "num_samples": 1}, allow_pickle=True)
    args = [f"input={tmp_path / 'results.npy'}", "rep=1", "num_iters=2"]
    fits, port_fit = [], smpl_fit.joints2smpl

    def recorded(joints, **kw):
        fits.append((joints, kw, port_fit(joints, **kw)))
        return fits[-1][2]

    monkeypatch.setattr(smpl_fit, "joints2smpl", recorded)
    assert render_motion_mesh_torch.main(args + [f"out_dir={tmp_path / 'port'}", "device=cpu"]) == 0
    ((joints, kw, fit),) = fits
    np.testing.assert_array_equal(joints, clips[1, :22].transpose(2, 0, 1)[:2])
    assert kw["pose_prior"] is smpl_fit.l2_prior and kw["cfg"] == smpl_fit.SMPLifyConfig(num_iters=2)
    direct = port_fit(joints, cfg=smpl_fit.SMPLifyConfig(num_iters=2), device="cpu")
    assert kw["device"] == torch.device("cpu")
    for a, b in zip(fit, direct):
        np.testing.assert_array_equal(a, b)

    def jax_fit(joints_, model=None, pose_prior=None, cfg=None):
        np.testing.assert_array_equal(joints_, joints)
        assert pose_prior is jax_smpl_fit.l2_prior and cfg.num_iters == 2 and (
            cfg.camera_iters == kw["cfg"].camera_iters)
        return fit

    monkeypatch.setattr(jax_smpl_fit, "joints2smpl", jax_fit)
    assert render_motion_mesh.main(args + [f"out_dir={tmp_path / 'jax'}"]) == 0
    want, got = (np.load(tmp_path / d / "smpl_thetas.npy") for d in ("jax", "port"))
    assert got.shape == (1, 25, 6, 2)
    np.testing.assert_array_equal(got, want)
    objs = [sorted(os.listdir(tmp_path / d / "objs")) for d in ("jax", "port")]
    assert objs[0] == objs[1] == ["frame000.obj", "frame001.obj"]
    for name in objs[0]:
        assert (tmp_path / "port" / "objs" / name).read_bytes() == (
            tmp_path / "jax" / "objs" / name).read_bytes()
    assert (tmp_path / "port" / "mesh.gif").stat().st_size > 0


def test_motion_soak_torch_runs_its_stages(tmp_path):
    tiny = [*TINY_VQ, "model.mmada.arch.d_model=64", "model.mmada.arch.n_heads=4",
            "model.mmada.arch.n_layers=2", "model.mmada.arch.mlp_hidden_size=128",
            "model.mmada.llm_vocab_size=256", "model.mmada.codebook_size=64",
            "model.mmada.motion_vocab_size=32", "dataset.n_patterns=4", "dataset.window_size=16",
            "dataset.max_motion_length=16", "dataset.preprocessing.max_seq_length=16",
            "training.batch_size=4", "training.batch_size_t2m=2", "device=cpu"]
    work = tmp_path / "soak"
    argv = ["vq_steps=2", "t2m_steps=2", f"workdir={work}", *tiny]
    assert motion_soak_torch.main(argv) == 0
    report = json.loads((work / "motion_soak.json").read_text())
    assert list(report["stages"]) == ["vq_train", "tokenize", "t2m_train", "eval"]
    assert report["stages"]["tokenize"] == {"clips": 4, "codes_per_clip": 12,
                                            "distinct_code_sequences": report["stages"][
                                                "tokenize"]["distinct_code_sequences"],
                                            "bank": str(work / "token_bank.npz")}
    bank = np.load(work / "token_bank.npz")
    assert bank["tokens"].shape == (4, 16) and (bank["tokens"][:, 12] == 32).all()
    assert report["stages"]["t2m_train"]["final_metrics"]["step"] == 2
    ev = report["stages"]["eval"]
    assert 0.0 <= ev["code_accuracy"] <= 1.0 and np.isfinite(ev["decoded_motion_mse_vs_clip"])
    assert set(ev["fast_arms"]) == {"kv_cache", "kv_refresh2"}
    assert isinstance(report["ok"], bool)
    with pytest.raises(ValueError, match="MOTION_SOAK_r03"):
        motion_soak_torch.main(argv + [f"out={tmp_path / 'MOTION_SOAK_r03.json'}"])


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_import_no_jax_or_the_jax_package(tool):
    forbidden = re.compile(r"^\s*(import|from) (jax|mmada_tpu)(\.| |$)", re.MULTILINE)
    with open(os.path.join(REPO, "tools", tool)) as f:
        assert forbidden.findall(f.read()) == []
