"""End-to-end text-to-motion evaluation.

The counterpart of `mmada_tpu/eval/t2m_eval.py` (`evaluation_mmada_t2m`,
utils/eval_trans.py:617+): for each eval batch, build the t2m frames, run
the MaskGIT motion sampler (`MMadaModel.t2m_generate`, the B1 / B2 attention
kernels on the card), decode the VQ codes to motion features, embed the
ground-truth and generated motions with the T2M evaluators, and aggregate
FID / diversity / R-precision / matching (numpy, `t2m_metrics`).
`evaluate_motion_vq` is `evaluation_vqvae` (utils/eval_trans.py:437+).

The motion VQ-VAE and the evaluators run in fp32 under
`core.precision.exact_fp32_products` (TF32 off, as the JAX package's fp32);
the sampler draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Optional

import numpy as np
import torch

from mmada_tpu_torch.core.precision import exact_fp32_products
from mmada_tpu_torch.eval import t2m_metrics as M
from mmada_tpu_torch.eval.motion_math import recover_from_ric
from mmada_tpu_torch.models import motion_vq

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class T2MEvalConfig:
    num_motion_tokens: int = 49
    timesteps: int = 18
    temperature: float = 1.0
    unit_length: int = 4
    top_k: int = 3
    diversity_times: int = 300


def build_t2m_frames(prompting, captions, num_motion_tokens, mask_id):
    motion = np.full((len(captions), num_motion_tokens), mask_id, np.int64)
    ids, masks, _ = prompting((list(captions), motion, motion), "t2m", dropout=False)
    return ids, masks


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def evaluate_mmada_t2m(model, vq, vq_cfg: motion_vq.MotionVQConfig, evaluator, prompting,
                       eval_batches: Iterable[dict], cfg: T2MEvalConfig = T2MEvalConfig(),
                       denormalize=None, generator: Optional[torch.Generator] = None,
                       max_batches: Optional[int] = None, embeddings: Optional[dict] = None
                       ) -> dict:
    """eval_batches: dicts of `collate_eval_items` (word_embs, pos_onehot,
    cap_lens, captions, motion, m_lens). `generator` (on the model's
    device; seed 0 when None) draws every batch's sampling in turn.
    `embeddings`, a dict, receives the text, ground-truth and generated
    embeddings and the codes (numpy), for checks."""
    device = model.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    text_embs, gt_embs, gen_embs, all_codes = [], [], [], []
    for i, batch in enumerate(eval_batches):
        if max_batches is not None and i >= max_batches:
            break
        captions = batch["captions"]
        frames, attn = build_t2m_frames(prompting, captions, cfg.num_motion_tokens,
                                        model.vocab.mask_token_id)
        codes = model.t2m_generate(
            torch.as_tensor(frames).to(device), attention_mask=torch.as_tensor(attn).to(device),
            temperature=cfg.temperature, timesteps=cfg.timesteps,
            num_motion_tokens=cfg.num_motion_tokens, generator=generator)
        codes = codes.clamp(0, model.vocab.motion_codebook_size - 1)
        all_codes.append(_np(codes).astype(np.int64))
        with exact_fp32_products():
            gen_motion = _np(motion_vq.decode(vq, vq_cfg, codes.to(vq.device)))
        if denormalize is not None:
            gen_motion = denormalize(gen_motion)

        # pad / trim the generated motion to the evaluator's max length; the
        # lengths are the frames after the trim
        t = batch["motion"].shape[1]
        gen_frames = min(gen_motion.shape[1], t)
        if gen_motion.shape[1] < t:
            gen_motion = np.pad(gen_motion, ((0, 0), (0, t - gen_motion.shape[1]), (0, 0)))
        else:
            gen_motion = gen_motion[:, :t]
        gen_lens = np.full((len(captions),), gen_frames, np.int32)

        with exact_fp32_products():
            text_emb, gt_emb = evaluator.get_co_embeddings(
                batch["word_embs"], batch["pos_onehot"], batch["cap_lens"], batch["motion"],
                batch["m_lens"])
            gen_emb = evaluator.get_motion_embeddings(gen_motion, gen_lens)
        text_embs.append(_np(text_emb))
        gt_embs.append(_np(gt_emb))
        gen_embs.append(_np(gen_emb))

    text_embs, gt_embs, gen_embs = (np.concatenate(e) for e in (text_embs, gt_embs, gen_embs))
    if embeddings is not None:
        embeddings.update(text=text_embs, gt=gt_embs, gen=gen_embs,
                          codes=np.concatenate(all_codes))
    results = M.evaluate_embeddings(text_embs, gt_embs, gen_embs, top_k=cfg.top_k,
                                    diversity_times=min(cfg.diversity_times, len(gen_embs) - 1))
    logger.info("t2m eval: %s", results)
    return results


@torch.no_grad()
def evaluate_motion_vq(vq, vq_cfg: motion_vq.MotionVQConfig, evaluator,
                       eval_batches: Iterable[dict], denormalize=None,
                       joints_num: Optional[int] = 22, top_k: int = 3,
                       diversity_times: int = 300, max_batches: Optional[int] = None,
                       embeddings: Optional[dict] = None) -> dict:
    """Motion-VQ reconstruction quality (`evaluation_vqvae`): encode and
    decode every eval motion through the VQ on its device, embed the ground
    truth and the reconstruction with the evaluators, and report FID /
    diversity / R-precision / matching on the reconstructions, plus MPJPE
    over the recovered joints (on `denormalize`d features when given;
    `joints_num=None` skips it, for widths other than HumanML3D's)."""
    text_embs, gt_embs, rec_embs = [], [], []
    mpjpe_sum, mpjpe_n = 0.0, 0
    for i, batch in enumerate(eval_batches):
        if max_batches is not None and i >= max_batches:
            break
        motion = torch.as_tensor(np.asarray(batch["motion"], np.float32)).to(vq.device)
        with exact_fp32_products():
            codes = motion_vq.encode(vq, vq_cfg, motion)
            # decode upsamples by the VQ stride; clip back to the source length
            recon = motion_vq.decode(vq, vq_cfg, codes)[:, :motion.shape[1]]
            text_emb, gt_emb = evaluator.get_co_embeddings(
                batch["word_embs"], batch["pos_onehot"], batch["cap_lens"], motion,
                batch["m_lens"])
            rec_emb = evaluator.get_motion_embeddings(recon, batch["m_lens"])
        text_embs.append(_np(text_emb))
        gt_embs.append(_np(gt_emb))
        rec_embs.append(_np(rec_emb))

        if joints_num is None:
            continue
        gt_np, rec_np = _np(motion), _np(recon)
        if denormalize is not None:
            gt_np, rec_np = denormalize(gt_np), denormalize(rec_np)
        for row, (g, r) in enumerate(zip(gt_np, rec_np)):
            t = int(batch["m_lens"][row])
            jg = np.asarray(recover_from_ric(g[:t], joints_num))
            jr = np.asarray(recover_from_ric(r[:t], joints_num))
            mpjpe_sum += float(np.linalg.norm(jg - jr, axis=-1).mean())
            mpjpe_n += 1

    text_embs, gt_embs, rec_embs = (np.concatenate(e) for e in (text_embs, gt_embs, rec_embs))
    if embeddings is not None:
        embeddings.update(text=text_embs, gt=gt_embs, rec=rec_embs)
    results = M.evaluate_embeddings(text_embs, gt_embs, rec_embs, top_k=top_k,
                                    diversity_times=min(diversity_times, len(rec_embs) - 1))
    if joints_num is not None:
        results["mpjpe"] = mpjpe_sum / max(mpjpe_n, 1)
    logger.info("motion-VQ eval: %s", results)
    return results


def collate_eval_items(items: list[dict]) -> dict:
    return {
        "word_embs": np.stack([i["word_embs"] for i in items]),
        "pos_onehot": np.stack([i["pos_onehot"] for i in items]),
        "cap_lens": np.asarray([i["cap_len"] for i in items]),
        "captions": [i["caption"] for i in items],
        "motion": np.stack([i["motion"] for i in items]),
        "m_lens": np.asarray([i["m_len"] for i in items]),
    }
