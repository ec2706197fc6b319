"""Motion VQ-VAE training on the card: `python train_motion_vq_torch.py ...`

The PyTorch port's counterpart of `train_motion_vq.py`: the 1-D conv VQ-VAE
trained with the recon + velocity + commit losses (`motion_vq.motion_losses`)
and its codebook variant (`model.motion_vq_model.quantizer`, the EMA-reset
codebook by default), on one of three loaders:

  * `dataset.synthetic_structured`: windows of the learnable clip bank
    (`data.synthetic.motion_clip`, `dataset.n_patterns` clips of three
    windows each) at the configured VQ size;
  * `dataset.synthetic`: normal noise windows (with `training.tiny`, on by
    default, at `tiny_motion_cfg()`);
  * `MotionVQDataset` windows of HumanML3D features under
    `dataset.motion_root` / `dataset.split_file`.

AdamW (`training.learning_rate`, `training.weight_decay`, no clip) updates
the conv weights; the codebook rides `forward_train`'s update (the
'gradient' variant trains it through the optimizer instead). A metrics line
every `training.log_every` steps under `experiment.output_dir`, and at the
end `checkpoint-{max_train_steps}` (the weights, by `CheckpointManager`) and
`motion_vq/` (`save_params_only`, which `load_params_only` and the loader's
`build_motion_vq` read back).

    python train_motion_vq_torch.py config=configs/motion_soak.yaml \\
        experiment.output_dir=/tmp/vq training.max_train_steps=200
    python train_motion_vq_torch.py dataset.synthetic=true device=cpu

With `eval.run_vq_eval=true` the trained VQ-VAE is evaluated at the end as
`train_motion_vq.py` does (`evaluate_motion_vq`: FID, R-precision,
matching, diversity and MPJPE of the reconstructions, by the T2M evaluators
of `eval.evaluator_dir` on the eval split of `dataset.motion_root` /
`dataset.split_file`), logged as `vq_eval/*` at step `max_train_steps`;
without those keys it raises before training (JAX's returns 1 after it).
One key more than `train_motion_vq.py`: `device` (the card unless
`device=cpu`).
"""

import logging
import os
import sys
import time

logger = logging.getLogger(__name__)


def batches(cfg, mcfg, batch_size: int):
    """(the loader's batches of (B, window, pose_dim) float32, the VQ config
    it trains: the tiny one for the `dataset.synthetic` smoke)."""
    import dataclasses

    import numpy as np

    from mmada_tpu_torch.models import motion_vq

    window = cfg.get_path("dataset.window_size", 64)
    tr = cfg.get_path("training", {})
    if cfg.get_path("dataset.synthetic_structured"):
        from mmada_tpu_torch.data import synthetic

        n_clips = int(cfg.get_path("dataset.n_patterns", 64))
        bank = np.stack([synthetic.motion_clip(k, length=3 * window, pose_dim=mcfg.pose_dim)
                         for k in range(n_clips)])

        def loader():
            rng = np.random.default_rng(0)
            while True:
                ks = rng.integers(0, n_clips, size=batch_size)
                starts = rng.integers(0, bank.shape[1] - window + 1, size=batch_size)
                yield np.stack([bank[k, s:s + window] for k, s in zip(ks, starts)])
        return loader(), mcfg
    if cfg.get_path("dataset.synthetic"):
        if tr.get("tiny", True):
            mcfg = dataclasses.replace(motion_vq.tiny_motion_cfg(), quantizer=mcfg.quantizer,
                                       beta=mcfg.beta)

        def loader():
            rng = np.random.default_rng(0)
            while True:
                yield rng.normal(size=(batch_size, window, mcfg.pose_dim)).astype(np.float32)
        return loader(), mcfg
    from mmada_tpu_torch.data.motion import MotionVQDataset
    from mmada_tpu_torch.data.text import batched

    ds = MotionVQDataset(cfg.get_path("dataset.motion_root"), cfg.get_path("dataset.split_file"),
                         window_size=window)
    return (np.stack(b) for b in batched(iter(ds), batch_size)), mcfg


def train(cfg):
    """Train from `cfg`; returns (the `MotionVQ`, its config, the logged
    metrics lines)."""
    import torch

    from mmada_tpu_torch.checkpoints.manager import CheckpointManager, save_params_only
    from mmada_tpu_torch.core.device import resolve_device
    from mmada_tpu_torch.core.precision import exact_fp32_products
    from mmada_tpu_torch.models import motion_vq
    from mmada_tpu_torch.serve.loader import motion_vq_config
    from mmada_tpu_torch.training.optimizers import AdamW
    from mmada_tpu_torch.utils.logging import MetricsLogger

    device = resolve_device(cfg.get("device"))
    evaluator = eval_batches = None
    if cfg.get_path("eval.run_vq_eval", False):
        from mmada_tpu_torch.eval.components import (build_eval_batches, build_evaluator,
                                                     build_word_vectorizer)

        evaluator = build_evaluator(cfg, device)
        eval_batches = evaluator and build_eval_batches(cfg, build_word_vectorizer(cfg))
        if eval_batches is None:
            raise ValueError("eval.run_vq_eval needs eval.evaluator_dir + dataset.motion_root + "
                             "dataset.split_file")
    tr = cfg.get_path("training", {})
    batch_size = tr.get("batch_size", 32)
    max_steps = tr.get("max_train_steps", 100)
    commit_w, vel_w = tr.get("commit_weight", 0.02), tr.get("vel_weight", 0.5)
    log_every = tr.get("log_every", 10)
    out_dir = cfg.get_path("experiment.output_dir", "motion-vq-output")
    loader, mcfg = batches(cfg, motion_vq_config(cfg), batch_size)

    vq = motion_vq.init_motion_vq(mcfg, device=device,
                                  generator=torch.Generator(device).manual_seed(0))
    cb_state = motion_vq.CodebookState.create(mcfg, device=device)
    # optax.adamw(lr, weight_decay): no clip; the decay (0 by default) on
    # every weight of two or more dimensions
    opt = AdamW(tr.get("learning_rate", 2e-4), weight_decay=tr.get("weight_decay", 0.0),
                max_grad_norm=None, no_decay_keys=())
    trained = vq.conv_parameters()
    if mcfg.quantizer == "gradient":
        trained["codebook"] = vq.codebook
    opt_state = opt.init(trained)
    names, leaves = zip(*trained.items())

    metrics = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    history = []
    for i, motion in enumerate(loader):
        if i >= max_steps:
            break
        t0 = time.perf_counter()
        x = torch.as_tensor(motion, dtype=torch.float32).to(device)
        with exact_fp32_products():
            recon, commit, ppl, new_cb, cb_state = motion_vq.forward_train(
                torch.Generator(device).manual_seed(i), vq, cb_state, mcfg, x)
            total, parts = motion_vq.motion_losses(recon, x, commit, commit_w, vel_w)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        opt.apply(dict(zip(names, leaves)),
                  {n: torch.zeros_like(t) if g is None else g
                   for n, t, g in zip(names, leaves, grads)}, opt_state)
        if mcfg.quantizer != "gradient":
            with torch.no_grad():
                vq.codebook.copy_(new_cb)
        if i % log_every == 0 or i == max_steps - 1:
            vals = {"step": i, "loss": float(total.detach()), "perplexity": float(ppl),
                    **{k: float(v.detach()) for k, v in parts.items()},
                    "seconds": time.perf_counter() - t0}
            metrics.log(vals)
            history.append(vals)
            logger.info("step %d loss %.4f ppl %.1f recon %.4f", i, vals["loss"],
                        vals["perplexity"], vals["recon"])
    if evaluator is not None:
        # the reconstruction eval (`evaluation_vqvae`, utils/eval_trans.py:437+)
        from mmada_tpu_torch.eval.t2m_eval import evaluate_motion_vq

        results = evaluate_motion_vq(vq, mcfg, evaluator, eval_batches,
                                     max_batches=cfg.get_path("eval.max_batches"))
        vals = {"step": max_steps, **{f"vq_eval/{k}": float(v) for k, v in results.items()}}
        metrics.log(vals)
        history.append(vals)
    metrics.close()
    CheckpointManager(out_dir).save(max_steps, dict(vq.state_dict()))
    save_params_only(os.path.join(out_dir, "motion_vq"), vq)
    logger.info("saved motion VQ-VAE to %s", out_dir)
    return vq, mcfg, history


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO)
    from train_torch import read_config

    train(read_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
