"""Model, tokenizer and prompting built from a config, for the command lines.

Counterpart of `mmada_tpu/serve/loader.py` (the reference entry points'
setup blocks, inference_t2i.py:56-85, inference_mmu.py:40-71,
generate.py:116-131). `model.mmada` takes either

  * `pretrained_model_path`: a local checkpoint directory (`config.json` and
    safetensors or `pytorch_model.bin`), streamed onto the card
    (`MMadaModel.from_pretrained`), then quantized if
    `model.mmada.quantize` names a scheme (`entry.quantize`); or
  * `tiny` / `random_init`: the architecture from the config (the flagship
    8B, `arch` overrides, `tie_word_embeddings`), random weights from
    `training.seed`.

`build_motion_vq` builds the motion VQ-VAE of `model.motion_vq_model` (its
`pretrained_path` where the file exists). `model.vq_model` takes `tiny`, or `vq_model_path` / `vq_model_name` naming a
local directory of MAGVIT-v2 weights; anything else falls back to random
weights, with a warning, as in JAX. The port's MAGVIT-v2 computes in fp32
whatever its weights' dtype (its codes are signs), so it is loaded in fp32
(JAX's `load_magvit2` default is bf16).

Every `build_*` takes `device` (the card unless told otherwise). Not ported:
`enable_compilation_cache` (XLA's).

Under a launcher of more than one rank (`torchrun`: the process group is
joined here, `core/mesh.initialize_distributed`, NCCL on the card, gloo with
`device=cpu`), `build_model` serves sharded, as JAX's loader does on a
slice (`serving_mesh`, `shard_for_serving`): `parallel.serving` `auto`
(the default) shards the weights over the mesh of `parallel.{data,fsdp,
tensor}` (default all fsdp; `parallel/sharding.py`), `pipeline` splits the
layers into GPipe stages over fsdp (`parallel/pipeline.py`; unquantized
weights and layers the stages divide), `none` keeps every rank's model
whole. Every rank then computes every request; the command lines print and
write on rank 0.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, NamedTuple, Optional

import torch

from mmada_tpu_torch.checkpoints.magvit_import import load_magvit2
from mmada_tpu_torch.core.config import (
    Config,
    parse_bool,
    parse_cfg_interval,
    parse_kv_cache,
    parse_remat,
)
from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.mesh import initialize_distributed, mesh_from_config
from mmada_tpu_torch.core.precision import policy_from_name
from mmada_tpu_torch.core.vocab import MMADA_8B, VocabLayout, tiny_layout
from mmada_tpu_torch.entry import QUANT_SCHEMES, quantize
from mmada_tpu_torch.models import llada, magvit2, motion_vq
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

logger = logging.getLogger(__name__)


#: The composed fast stack, resolved per family (the quality evidence is per
#: family, BASELINE.md rounds 3q-3u, MMU_GATE_r05): text needs the refresh
#: cadence and the warmup; MMU keeps its quality under the int8 freeze with
#: the tau-parallel commit; t2i is within slack under the plain block-KV cache.
FAST_STACK_PRESET = {
    "text": {"kv_cache": "int8", "parallel_threshold": 0.9,
             "parallel_warmup_steps": 8, "cache_refresh_every": 4},
    "mmu": {"kv_cache": "int8", "parallel_threshold": 0.9,
            "parallel_warmup_steps": 2, "cache_refresh_every": 0},
    "t2i": {"kv_cache": True, "parallel_threshold": 0.0,
            "parallel_warmup_steps": 0, "cache_refresh_every": 0},
}


def task_serving_defaults(cfg: Config, task: str) -> dict:
    """The fast-decode defaults of one task family: `serving.<task>.<key>`
    over the flat `serving.<key>` over the fallback, which
    `serving.fast_stack: true` (or `serving.<task>.fast_stack`) swaps for
    FAST_STACK_PRESET's family entry. cfg_interval is not part of the
    preset. Each value goes through its strict parser."""

    def g(key, fallback, cast):
        v = cfg.get_path(f"serving.{task}.{key}", None)
        if v is None:
            v = cfg.get_path(f"serving.{key}", fallback)
        return cast(v)

    fb = {"kv_cache": False, "parallel_threshold": 0.0,
          "parallel_warmup_steps": 0, "cache_refresh_every": 0}
    if g("fast_stack", False, parse_bool):
        # families without gate evidence (t2m) keep the exact fallbacks
        fb = {**fb, **FAST_STACK_PRESET.get(task, {})}
    return {
        "kv_cache": g("kv_cache", fb["kv_cache"], parse_kv_cache),
        "parallel_threshold": g("parallel_threshold", fb["parallel_threshold"], float),
        "parallel_warmup_steps": g("parallel_warmup_steps", fb["parallel_warmup_steps"], int),
        "cache_refresh_every": g("cache_refresh_every", fb["cache_refresh_every"], int),
        "segment_steps": g("segment_steps", 0, int),
        "segment_timesteps": g("segment_timesteps", 0, int),
        "cfg_interval": g("cfg_interval", None, parse_cfg_interval),
    }


def build_text_tokenizer(cfg: Config):
    """The checkpoint's tokenizer through `transformers` (local files only),
    or, where that fails (no tokenizer files, no `transformers`), the
    `ByteTokenizer`, with a warning."""
    path = cfg.get_path("model.mmada.tokenizer_path") or cfg.get_path(
        "model.mmada.pretrained_model_path")
    if path and not cfg.get_path("model.mmada.random_init", False):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(path, trust_remote_code=True,
                                                 local_files_only=True)
        except Exception as e:  # a checkpoint without tokenizer files must still serve
            logger.warning("AutoTokenizer.from_pretrained(%s) failed (%s); falling back to "
                           "ByteTokenizer", path, e)
            return ByteTokenizer()
    logger.warning("using ByteTokenizer (no pretrained tokenizer configured)")
    return ByteTokenizer()


def build_vocab(cfg: Config) -> VocabLayout:
    m = cfg.get_path("model.mmada", Config())
    if m.get("tiny"):
        # ByteTokenizer emits ids up to 16+256=272; keep specials/mask above
        return tiny_layout(
            text_vocab_size=max(m.get("llm_vocab_size", 256), 300),
            image_codebook_size=m.get("codebook_size", 64),
            motion_codebook_size=m.get("motion_vocab_size", 0),
            motion_special=2 if m.get("motion_vocab_size") else 0,
        )
    vocab = MMADA_8B
    nnst = int(m.get("num_new_special_tokens", 0) or 0)
    if nnst:
        # appended special tokens extend the text region, pushing the VQ
        # windows up (modeling_mmada.py:168)
        vocab = dataclasses.replace(vocab, text_vocab_size=vocab.text_vocab_size + nnst)
    if m.get("motion_vocab_size"):
        vocab = vocab.with_motion(m["motion_vocab_size"])
    return vocab


def build_prompting(cfg: Config, tokenizer, vocab: VocabLayout) -> UniversalPrompting:
    if cfg.get_path("model.mmada.tiny"):
        sp = SpecialIds(
            soi=vocab.text_vocab_size - 20, eoi=vocab.text_vocab_size - 19,
            t2i=vocab.text_vocab_size - 18, mmu=vocab.text_vocab_size - 17,
            r2i=vocab.text_vocab_size - 16, t2m=vocab.text_vocab_size - 15,
            som=vocab.text_vocab_size - 14, eom=vocab.text_vocab_size - 13,
            pad=vocab.pad_token_id,
            bos=getattr(tokenizer, "bos_token_id", 1) or 1,
            eos=getattr(tokenizer, "eos_token_id", 2) or 2,
        )
    else:
        sp = SpecialIds.from_vocab(vocab)
        if getattr(tokenizer, "bos_token_id", None) is not None:
            sp = dataclasses.replace(sp, bos=tokenizer.bos_token_id, eos=tokenizer.eos_token_id)
        # chat prompt masks key off <|end_header_id|> (prompting_utils.py:271-314)
        if hasattr(tokenizer, "convert_tokens_to_ids"):
            try:
                eh = tokenizer.convert_tokens_to_ids("<|end_header_id|>")
                unk = getattr(tokenizer, "unk_token_id", None)
                if eh is not None and eh >= 0 and eh != unk:
                    sp = dataclasses.replace(sp, end_header=eh)
            except Exception:  # a tokenizer without the token keeps no end_header
                pass
    return UniversalPrompting(
        tokenizer, sp,
        max_text_len=cfg.get_path("dataset.preprocessing.max_seq_length", 512),
        cond_dropout_prob=cfg.get_path("training.cond_dropout_prob", 0.1),
    )


def serving_mesh(cfg: Config, device: DeviceLike = None):
    """The mesh to serve over when the run has more than one rank (joining
    the launcher's ranks first), or None (one rank, or `parallel.serving:
    none`)."""
    initialize_distributed(device=device)
    if not torch.distributed.is_initialized() or torch.distributed.get_world_size() == 1:
        return None
    if str(cfg.get_path("parallel.serving", "auto")).lower() == "none":
        return None
    return mesh_from_config(cfg, device)


def shard_for_serving(cfg: Config, model: MMadaModel, mesh=None) -> MMadaModel:
    """`model` over `mesh` (default `serving_mesh(cfg)`): sharded (`auto`)
    or in pipeline stages (`pipeline`), as JAX's `_maybe_shard`; itself
    without a mesh or with `parallel.serving: none`."""
    from mmada_tpu_torch.parallel import pipeline, sharding

    mode = str(cfg.get_path("parallel.serving", "auto")).lower()
    if mode not in ("auto", "none", "pipeline"):
        raise ValueError(f"parallel.serving must be auto, none or pipeline, got {mode!r}")
    if mesh is None:
        mesh = serving_mesh(cfg, model.device)
    if mesh is None or mode == "none":
        return model
    if mode == "pipeline":
        stages = mesh.size(1)
        if model.cfg.n_layers % stages:
            raise ValueError(f"{model.cfg.n_layers} layers do not divide the fsdp axis "
                             f"({stages}) for pipeline stages")
        logger.info("pipeline serving: %d stages over mesh %s", stages, tuple(mesh.shape))
        return dataclasses.replace(model, params=pipeline.shard_stage_params(model.params, mesh),
                                   mesh=mesh, pipeline_axis="fsdp")
    logger.info("serving sharded over mesh %s", tuple(mesh.shape))
    specs = sharding.model_specs(model.cfg, mesh, model.params)
    return dataclasses.replace(model, params=sharding.shard_params(model.params, specs, mesh),
                               mesh=mesh)


def build_model(cfg: Config, vocab: VocabLayout, device: DeviceLike = None) -> MMadaModel:
    """The model of `cfg` (see the module docstring), over the serving mesh
    when the run has more than one rank."""
    return shard_for_serving(cfg, _build_model(cfg, vocab, device))


def _build_model(cfg: Config, vocab: VocabLayout, device: DeviceLike = None) -> MMadaModel:
    device = resolve_device(device)
    m = cfg.get_path("model.mmada", Config())
    policy = policy_from_name(
        cfg.get_path("training.mixed_precision", "bf16") if not m.get("tiny") else "fp32")
    remat = parse_remat(cfg.get_path("training.gradient_checkpointing",
                                     cfg.get_path("model.gradient_checkpointing", False)))
    if m.get("random_init") or m.get("tiny"):
        if m.get("tiny"):
            arch = llada.tiny_config(vocab_size=vocab.total_vocab_size)
            arch = dataclasses.replace(arch, mask_token_id=vocab.mask_token_id)
        else:
            arch = llada.llada_8b(vocab.total_vocab_size)
            overrides = m.get("arch")
            if overrides:
                # mid-scale proxies: the flagship's traits at another width or depth
                arch = dataclasses.replace(arch, **{k: overrides[k] for k in (
                    "d_model", "n_heads", "n_kv_heads", "n_layers", "mlp_hidden_size",
                    "max_sequence_length", "rope_theta", "weight_tying",
                ) if overrides.get(k) is not None})
        if "tie_word_embeddings" in m:
            # random init only: a checkpoint's own config decides whether it has a head
            arch = dataclasses.replace(arch, weight_tying=bool(m["tie_word_embeddings"]))
        generator = torch.Generator(device).manual_seed(int(cfg.get_path("training.seed", 0)))
        return MMadaModel.init(arch, vocab, device=device, dtype=policy.param_dtype,
                               generator=generator, policy=policy, remat=remat)
    path = m.get("pretrained_model_path")
    if not path:
        raise ValueError("model.mmada.pretrained_model_path or tiny/random_init required")
    model = MMadaModel.from_pretrained(path, vocab, device=device, dtype=policy.param_dtype,
                                       policy=policy, remat=remat)
    if m.get("quantize") in QUANT_SCHEMES:
        model = quantize(model, m["quantize"], smoothquant_calib=m.get("smoothquant_calib"),
                         smoothquant_alpha=float(m.get("smoothquant_alpha", 0.5)))
    return model


def build_vq_model(cfg: Config, device: DeviceLike = None):
    """(params, vq_cfg) of the MAGVIT-v2 tokenizer."""
    device = resolve_device(device)
    v = cfg.get_path("model.vq_model", Config())
    if v.get("tiny"):
        vq_cfg = magvit2.tiny_vqgan()
        return magvit2.init_magvit2(vq_cfg, device=device,
                                    generator=torch.Generator(device).manual_seed(1)), vq_cfg
    vq_cfg = magvit2.magvit2_default()
    path = v.get("vq_model_path") or v.get("vq_model_name")
    if path and v.get("local", True) and os.path.isdir(str(path)):
        return load_magvit2(str(path), vq_cfg, device=device, dtype=torch.float32), vq_cfg
    logger.warning("VQ model %s unavailable locally; random init", path)
    return magvit2.init_magvit2(vq_cfg, device=device,
                                generator=torch.Generator(device).manual_seed(1)), vq_cfg


def motion_vq_config(cfg: Config):
    """`model.motion_vq_model` as a `MotionVQConfig`, with JAX's defaults
    (`train_motion_vq.py`)."""
    m = cfg.get_path("model.motion_vq_model", Config())
    return motion_vq.MotionVQConfig(
        pose_dim=m.get("pose_dim", 263), code_dim=m.get("code_dim", 512),
        nb_code=m.get("nb_code", 512), width=m.get("width", 512), down_t=m.get("down_t", 2),
        depth=m.get("depth", 3), dilation_growth_rate=m.get("dilation_growth_rate", 3),
        mu=m.get("mu", 0.99), quantizer=m.get("quantizer", "ema_reset"),
        beta=m.get("beta", 1.0))


def build_motion_vq(cfg: Config, device: DeviceLike = None):
    """(MotionVQ, MotionVQConfig) of `model.motion_vq_model`: its
    `pretrained_path` when it exists (a `save_params_only` directory, as
    `train_motion_vq_torch.py` writes, or a reference `HumanVQVAE` state dict
    in a .safetensors file), else random weights from seed 0, with a warning
    (JAX's `eval_t2m.py` loads the file only where it exists)."""
    from mmada_tpu_torch.checkpoints.manager import load_params_only
    from mmada_tpu_torch.checkpoints.motion_import import motion_vq_from_torch
    from mmada_tpu_torch.checkpoints.safetensors_io import iter_safetensors

    device = resolve_device(device)
    vq_cfg = motion_vq_config(cfg)
    path = cfg.get_path("model.motion_vq_model.pretrained_path")
    vq = motion_vq.init_motion_vq(vq_cfg, device=device,
                                  generator=torch.Generator(device).manual_seed(0))
    if path and os.path.isdir(str(path)):
        return load_params_only(str(path), vq), vq_cfg
    if path and os.path.isfile(str(path)):
        return motion_vq_from_torch(dict(iter_safetensors(str(path))), vq_cfg,
                                    device=device), vq_cfg
    logger.warning("motion VQ-VAE %s unavailable locally; random init", path)
    return vq, vq_cfg


class Loaded(NamedTuple):
    """What `load_all` builds; unpacks as JAX's tuple does."""

    model: MMadaModel
    vq: Any
    vq_cfg: Optional[magvit2.VQGANConfig]
    tokenizer: Any
    prompting: UniversalPrompting
    vocab: VocabLayout


def load_all(cfg: Config, device: DeviceLike = None) -> Loaded:
    """(model, vq, vq_cfg, tokenizer, prompting, vocab) in one call."""
    tokenizer = build_text_tokenizer(cfg)
    vocab = build_vocab(cfg)
    prompting = build_prompting(cfg, tokenizer, vocab)
    model = build_model(cfg, vocab, device)
    vq, vq_cfg = build_vq_model(cfg, device)
    return Loaded(model, vq, vq_cfg, tokenizer, prompting, vocab)
