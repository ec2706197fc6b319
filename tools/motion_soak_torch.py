"""The motion family end to end on the card: VQ training, tokenization, t2m
training and a generation eval, through the port's entry points.

The PyTorch port's counterpart of `tools/motion_soak.py`, its stages run in
this process:

  1. vq_train  - `train_motion_vq_torch.train` on the learnable clip bank
                 (`data.synthetic.motion_clip`) at the configured VQ size;
  2. tokenize  - each clip encoded by the trained VQ (`motion_vq.encode`),
                 padded MotionTokenDataset-style (codes, EOM, PAD...) into
                 `token_bank.npz`;
  3. t2m_train - `train_torch.run` with `training.task=t2m` on the bank
                 (caption -> its fixed code sequence), full-parameter;
  4. eval      - greedy `t2m_generate` on every bank caption: code accuracy
                 against the bank (and with the block-KV cache, refreshed
                 never and every 2 steps), and the decoded motion's MSE
                 against the original clips through the trained decoder.

    python tools/motion_soak_torch.py [vq_steps=1500] [t2m_steps=3000]
        [config=configs/motion_soak.yaml] [workdir=motion-soak-torch]
        [out=<workdir>/motion_soak.json] [device=cpu] [<dotted.key>=<value> ...]

Every other `key=value` (`device`, a dotted config key) is applied to each
stage's config. The report goes to `out`, by default under `workdir`; it
never writes the JAX rounds' `MOTION_SOAK_r03.json`.
"""

import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

logger = logging.getLogger("motion_soak_torch")
JAX_REPORT = "MOTION_SOAK_r03.json"


def vq_stage(config: str, steps: int, workdir: str, overrides: list) -> dict:
    """Stage 1: the trained (MotionVQ, MotionVQConfig) and the stage's report."""
    import train_motion_vq_torch
    from train_torch import read_config

    out_dir = os.path.join(workdir, "vq")
    t0 = time.perf_counter()
    vq, mcfg, history = train_motion_vq_torch.train(read_config(
        [f"config={config}", *overrides, f"training.max_train_steps={steps}",
         f"experiment.output_dir={out_dir}"]))
    return dict(vq=vq, mcfg=mcfg, report={
        "steps": steps, "seconds": round(time.perf_counter() - t0, 1), "output_dir": out_dir,
        "final_metrics": history[-1] if history else {}})


def tokenize_stage(cfg, vq, mcfg, workdir: str) -> dict:
    """Stage 2: the clip bank, its codes and the padded token bank on disk."""
    import numpy as np
    import torch

    from mmada_tpu_torch.data import synthetic
    from mmada_tpu_torch.models import motion_vq

    n_clips = int(cfg.get_path("dataset.n_patterns", 48))
    n_motion = int(cfg.get_path("dataset.max_motion_length", 55))
    window = int(cfg.get_path("dataset.window_size", 64))
    clips = np.stack([synthetic.motion_clip(k, length=3 * window, pose_dim=mcfg.pose_dim)
                      for k in range(n_clips)])
    device = next(vq.parameters()).device
    with torch.no_grad():
        codes = motion_vq.encode(vq, mcfg, torch.as_tensor(clips, device=device)).cpu().numpy()
    m_len = codes.shape[1]
    if m_len + 1 > n_motion:
        raise ValueError(f"{m_len} codes a clip do not fit max_motion_length {n_motion}")
    eom, pad = mcfg.nb_code, mcfg.nb_code + 1
    padded = np.concatenate([codes, np.full((n_clips, 1), eom),
                             np.full((n_clips, n_motion - 1 - m_len), pad)],
                            axis=1).astype(np.int64)
    caps = [synthetic.motion_caption(k) for k in range(n_clips)]
    bank = os.path.join(workdir, "token_bank.npz")
    np.savez(bank, captions=np.asarray(caps), tokens=padded, lengths=np.full(n_clips, m_len))
    distinct = len({tuple(r) for r in codes.tolist()})
    logger.info("tokenized %d clips -> %d codes each (%d distinct)", n_clips, m_len, distinct)
    return dict(clips=clips, codes=codes, padded=padded, captions=caps, bank=bank, report={
        "clips": n_clips, "codes_per_clip": int(m_len), "distinct_code_sequences": distinct,
        "bank": bank})


def t2m_stage(config: str, steps: int, bank: str, workdir: str, overrides: list) -> dict:
    """Stage 3: `train_torch.run`'s T2MRun (its model holds the trained
    weights: the optimizer updates the stacked weights through their views)."""
    import train_torch

    out_dir = os.path.join(workdir, "t2m")
    t0 = time.perf_counter()
    run = train_torch.run(train_torch.read_config(
        [f"config={config}", *overrides, "training.task=t2m", f"dataset.token_bank={bank}",
         f"training.max_train_steps={steps}", f"experiment.output_dir={out_dir}"]))
    return dict(run=run, report={"steps": steps, "seconds": round(time.perf_counter() - t0, 1),
                                 "final_metrics": run.history[-1] if run.history else {}})


def eval_stage(run, vq, mcfg, tok: dict) -> dict:
    """Stage 4: greedy generation on the bank's captions, against the bank
    and, decoded, against the clips."""
    import numpy as np
    import torch

    from mmada_tpu_torch.models import motion_vq

    model, vocab, device = run.model, run.vocab, run.device
    padded, codes, clips = tok["padded"], tok["codes"], tok["clips"]
    n_clips, n_motion = padded.shape
    m_len = codes.shape[1]
    masked = np.full((n_clips, n_motion), vocab.mask_token_id, np.int64)
    ids, attn, _ = run.prompting((tok["captions"], masked, masked), "t2m", dropout=False)
    ids = torch.as_tensor(np.asarray(ids), device=device)
    attn = torch.as_tensor(np.asarray(attn), device=device)

    def generate(**kw):
        with torch.no_grad():
            return model.t2m_generate(ids, attention_mask=attn, temperature=0.0, greedy=True,
                                      timesteps=18, num_motion_tokens=n_motion, **kw).cpu().numpy()

    gen = generate()
    code_acc = float((gen[:, :m_len] == codes).mean())
    arms = {}
    for name, kw in (("kv_cache", dict(block_kv_cache=True)),
                     ("kv_refresh2", dict(block_kv_cache=True, cache_refresh_every=2))):
        acc = float((generate(**kw)[:, :m_len] == codes).mean())
        arms[name] = {"code_accuracy": round(acc, 4), "promote": bool(acc >= code_acc - 0.01)}
    vq_device = next(vq.parameters()).device

    def decoded(c):
        return motion_vq.decode(vq, mcfg, torch.as_tensor(c, device=vq_device)).cpu().numpy()

    dec = decoded(np.clip(gen[:, :m_len], 0, mcfg.nb_code - 1))
    ref = decoded(codes)
    return {
        "token_accuracy_incl_eom_pad": round(float((gen == padded).mean()), 4),
        "code_accuracy": round(code_acc, 4),
        "decoded_motion_mse_vs_clip": round(float(((dec - clips[:, :dec.shape[1]]) ** 2).mean()),
                                            5),
        "vq_recon_mse_vs_clip": round(float(((ref - clips[:, :ref.shape[1]]) ** 2).mean()), 5),
        "clip_variance": round(float(clips.var()), 5),
        "fast_arms": arms,
    }


def soak(config: str, vq_steps: int, t2m_steps: int, workdir: str, overrides: list) -> dict:
    """The four stages; returns the report (`ok`: code accuracy above 0.9
    and both MSEs under half the clips' variance, as JAX's soak)."""
    from train_torch import read_config

    os.makedirs(workdir, exist_ok=True)
    report = {"config": config, "stages": {}}
    vq = vq_stage(config, vq_steps, workdir, overrides)
    report["stages"]["vq_train"] = vq["report"]
    tok = tokenize_stage(read_config([f"config={config}", *overrides]), vq["vq"], vq["mcfg"],
                         workdir)
    report["stages"]["tokenize"] = tok["report"]
    t2m = t2m_stage(config, t2m_steps, tok["bank"], workdir, overrides)
    report["stages"]["t2m_train"] = t2m["report"]
    ev = eval_stage(t2m["run"], vq["vq"], vq["mcfg"], tok)
    report["stages"]["eval"] = ev
    report["ok"] = bool(ev["code_accuracy"] > 0.9 and
                        ev["vq_recon_mse_vs_clip"] < 0.5 * ev["clip_variance"] and
                        ev["decoded_motion_mse_vs_clip"] < 0.5 * ev["clip_variance"])
    return report


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = dict(kv.split("=", 1) for kv in argv if "=" in kv)
    config = args.pop("config", "configs/motion_soak.yaml")
    vq_steps, t2m_steps = int(args.pop("vq_steps", 1500)), int(args.pop("t2m_steps", 3000))
    workdir = args.pop("workdir", "motion-soak-torch")
    out = args.pop("out", os.path.join(workdir, "motion_soak.json"))
    if os.path.basename(out) == JAX_REPORT:
        raise ValueError(f"{out}: {JAX_REPORT} is the JAX rounds' report; write elsewhere")
    report = soak(config, vq_steps, t2m_steps, workdir, [f"{k}={v}" for k, v in args.items()])
    with open(out, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps({"ok": report["ok"], **report["stages"]["eval"]}))
    logger.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
