"""In-training validation hooks.

Counterpart of `mmada_tpu/training/validation.py:42-245` (the reference's
wandb-logged hooks, SURVEY.md §4): `generate_images` (train_mmada.py:798-868),
`visualize_predictions` (:750-795), `understanding_images` (:872-932),
`quantative_images` (stage4:1008-1115) and `generate_chat_text`
(stage3:976-1046), on the port's samplers. Each writes
under `{output_dir}/validation/step_{N}/` the files JAX's writes, with their
names and contents: `t2i_{i:03d}.png` and `t2i_prompts.jsonl`;
`pred_{i:03d}_{original,recon,model}.png`; `mmu_answers.jsonl`;
`quantative.json`; `chat.jsonl`. The package imports no PIL, so the images go through the
caller's `write_image(path, (H, W, 3) uint8 array)` (`train_torch.write_png`);
the pixels are JAX's `_save_image` conversion, `clip((x + 1) * 127.5, 0,
255)` cast to uint8. JAX's random keys become torch generators (default:
seeded 0 on the model's device).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mmada_tpu_torch.models import magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.sampling.schedules import cosine_schedule
from mmada_tpu_torch.training import masking

ImageWriter = Callable[[str, np.ndarray], None]


def _out_dir(base: str, step: int) -> str:
    path = os.path.join(base, "validation", f"step_{step}")
    os.makedirs(path, exist_ok=True)
    return path


def to_uint8(pixels) -> np.ndarray:
    """JAX's `_save_image` conversion of [-1, 1] pixels."""
    arr = np.asarray(torch.as_tensor(pixels).float().cpu())
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _device(model: MMadaModel) -> torch.device:
    return model.params["wte"].device


def _generator(model: MMadaModel, generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator(_device(model)).manual_seed(0)


def _vq_device(vq_params) -> torch.device:
    return vq_params["encoder"]["conv_in"]["w"].device


@torch.no_grad()
def generate_images(
    model: MMadaModel,
    vq_params, vq_cfg,
    prompting,
    prompts: Sequence[str],
    output_dir: str,
    step: int,
    write_image: ImageWriter,
    num_vq_tokens: int = 1024,
    timesteps: int = 12,
    guidance_scale: float = 1.5,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """t2i from validation prompts (validation_prompts/*.txt); returns the
    decoded pixels (B, H, W, 3) in [-1, 1]."""
    device = _device(model)
    mask_id = model.vocab.mask_token_id
    image_ids = np.full((len(prompts), num_vq_tokens), mask_id, np.int64)
    ids, attn = prompting((list(prompts), image_ids), "t2i_gen")
    uncond_ids, uncond_attn = prompting.t2i_gen_uncond(len(prompts), num_vq_tokens, mask_id)

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    codes = model.t2i_generate(
        t(ids), uncond_input_ids=t(uncond_ids), attention_mask=t(attn),
        uncond_attention_mask=t(uncond_attn), timesteps=timesteps,
        guidance_scale=guidance_scale, num_vq_tokens=num_vq_tokens,
        generator=_generator(model, generator),
    )
    pixels = magvit2.decode_code(vq_params, vq_cfg, codes.to(_vq_device(vq_params)))
    pixels = pixels.float().cpu().numpy()
    out = _out_dir(output_dir, step)
    for i in range(len(prompts)):
        write_image(os.path.join(out, f"t2i_{i:03d}.png"), to_uint8(pixels[i]))
    with open(os.path.join(out, "t2i_prompts.jsonl"), "w") as f:
        for i, p in enumerate(prompts):
            f.write(json.dumps({"index": i, "prompt": p}) + "\n")
    return pixels


@torch.no_grad()
def visualize_predictions(
    model: MMadaModel,
    vq_params, vq_cfg,
    prompting,
    images: np.ndarray,            # (B, H, W, C) pixels in [-1, 1]
    captions: Sequence[str],
    output_dir: str,
    step: int,
    write_image: ImageWriter,
    mask_schedule=None,
    generator: Optional[torch.Generator] = None,
):
    """Original vs VQ reconstruction vs model prediction triplets
    (train_mmada.py:750-795); returns (recon, predicted) pixels."""
    device = _device(model)
    vocab = model.vocab
    x = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(_vq_device(vq_params))
    codes = magvit2.get_code(vq_params, vq_cfg, x)
    recon = magvit2.decode_code(vq_params, vq_cfg, codes).float().cpu().numpy()

    fused = codes.cpu().numpy() + vocab.image_offset
    ids, attn, _ = prompting((list(captions), fused, fused), "t2i", dropout=False)
    ids = torch.as_tensor(np.asarray(ids)).to(device)
    span = slice(prompting.max_text_len + 1, ids.shape[1] - 1)
    noisy_span, _, _ = masking.mask_image_tokens(
        _generator(model, generator), ids[:, span], vocab.mask_token_id,
        mask_schedule=mask_schedule or cosine_schedule,
    )
    noisy = ids.clone()
    noisy[:, span] = noisy_span

    logits = model.forward(noisy, logit_window=vocab.image_window)
    pred = torch.argmax(logits[:, span], dim=-1)
    # keep unmasked positions from the original grid
    unmasked = noisy_span != vocab.mask_token_id
    pred = torch.where(unmasked, noisy_span - vocab.image_offset, pred)
    pred_pixels = magvit2.decode_code(vq_params, vq_cfg, pred.to(_vq_device(vq_params)))
    pred_pixels = pred_pixels.float().cpu().numpy()

    out = _out_dir(output_dir, step)
    for i in range(images.shape[0]):
        write_image(os.path.join(out, f"pred_{i:03d}_original.png"), to_uint8(images[i]))
        write_image(os.path.join(out, f"pred_{i:03d}_recon.png"), to_uint8(recon[i]))
        write_image(os.path.join(out, f"pred_{i:03d}_model.png"), to_uint8(pred_pixels[i]))
    return recon, pred_pixels


@torch.no_grad()
def understanding_images(
    model: MMadaModel,
    vq_params, vq_cfg,
    prompting,
    tokenizer,
    images: np.ndarray,
    question,
    output_dir: str,
    step: int,
    max_new_tokens: int = 64,
    steps: int = 32,
    generator: Optional[torch.Generator] = None,
) -> list[str]:
    """Caption/answer for validation images (train_mmada.py:872-932).

    `question` is one string for all images, or one per image (the
    reference's prompts_with_vqa.json pairs each validation image with its
    own task-typed question)."""
    device = _device(model)
    vocab = model.vocab
    sp = prompting.sp
    x = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(_vq_device(vq_params))
    codes = magvit2.get_code(vq_params, vq_cfg, x).cpu().numpy()
    fused = codes + vocab.image_offset
    questions = (
        [question] * images.shape[0]
        if isinstance(question, str) else list(question)
    )
    if len(questions) != images.shape[0]:
        raise ValueError(f"{len(questions)} questions for {images.shape[0]} images")
    frames = []
    for i in range(images.shape[0]):
        text_ids = tokenizer([questions[i]])["input_ids"][0]
        frames.append(np.concatenate(
            [[sp.mmu, sp.soi], fused[i], [sp.eoi, sp.bos], text_ids]
        ))
    max_len = max(len(fr) for fr in frames)
    # left-pad to a common length so one batched mmu_generate covers
    # variable-length questions (prompt region stays intact on the right)
    frames = np.stack([
        np.concatenate([np.full(max_len - len(fr), sp.pad), fr])
        for fr in frames
    ]).astype(np.int64)
    out_tokens = model.mmu_generate(
        torch.as_tensor(frames).to(device), max_new_tokens=max_new_tokens, steps=steps,
        block_length=max_new_tokens, generator=_generator(model, generator),
    )
    answers = []
    for i in range(images.shape[0]):
        ans = out_tokens[i, frames.shape[1]:].cpu().numpy()
        ans = ans[ans < vocab.text_vocab_size]
        answers.append(tokenizer.decode(ans.tolist()))
    out = _out_dir(output_dir, step)
    with open(os.path.join(out, "mmu_answers.jsonl"), "w") as f:
        for i, a in enumerate(answers):
            f.write(json.dumps({"index": i, "question": questions[i], "answer": a}) + "\n")
    return answers


def quantative_images(
    model: MMadaModel,
    vq_params, vq_cfg,
    prompting,
    prompts: Sequence[str],
    scorer,
    output_dir: str,
    step: int,
    write_image: ImageWriter,
    **gen_kwargs,
) -> dict:
    """The stage-4 quality eval (train_mmada_stage4.py:1008-1115):
    `generate_images` from the quantative prompts, scored with CLIP and
    ImageReward by `scorer` (an `eval.image_quality.ImageQualityScorer`,
    None for generation only); writes and returns the summary
    (`quantative.json`)."""
    pixels = generate_images(model, vq_params, vq_cfg, prompting, prompts, output_dir, step,
                             write_image, **gen_kwargs)
    results = scorer.quantitative_images(pixels, prompts) if scorer else {}
    with open(os.path.join(_out_dir(output_dir, step), "quantative.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


@torch.no_grad()
def generate_chat_text(
    model: MMadaModel,
    tokenizer,
    questions: Sequence[str],
    output_dir: str,
    step: int,
    gen_length: int = 128,
    steps: int = 64,
    block_length: int = 32,
    generator: Optional[torch.Generator] = None,
) -> list[str]:
    """QA transcript generation (stage3:976-1046)."""
    device = _device(model)
    answers = []
    for q in questions:
        if hasattr(tokenizer, "apply_chat_template"):
            try:
                text = tokenizer.apply_chat_template(
                    [{"role": "user", "content": q}],
                    add_generation_prompt=True, tokenize=False,
                )
            except Exception:  # a tokenizer whose template is missing or broken
                text = q
        else:
            text = q
        ids = torch.as_tensor(tokenizer([text])["input_ids"], dtype=torch.long).to(device)
        out = model.generate(ids, gen_length=gen_length, steps=steps,
                             block_length=block_length, generator=_generator(model, generator))
        ans = out[0, ids.shape[1]:].cpu().numpy()
        ans = ans[ans < model.vocab.text_vocab_size]
        answers.append(tokenizer.decode(ans.tolist()))
    out_dir = _out_dir(output_dir, step)
    with open(os.path.join(out_dir, "chat.jsonl"), "w") as f:
        for q, a in zip(questions, answers):
            f.write(json.dumps({"question": q, "answer": a}) + "\n")
    return answers
