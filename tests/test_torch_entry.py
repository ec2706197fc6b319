"""The port's entry points, its import boundary and its kernel build.

* `serve_text` / `serve_t2i` on the CPU answer requests token-exactly as the
  JAX package does on the same weights and frames (the serving slice as a
  whole), `serve_t2i` with attention masks on too; `train` takes train steps
  on the CPU when asked to, masked or not.
* `mmada_tpu_torch`, `chip_smoke.py` and `profile_cached.py` import neither
  jax, the JAX package, yaml nor PIL (none of them is installed beside the
  card), and a train step runs without them.
* Entry points never fall back to the CPU on their own.
* The nvcc build targets sm_90a and writes into a gitignored directory.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting.universal import SpecialIds as JaxSpecialIds
from mmada_tpu.prompting.universal import UniversalPrompting as JaxPrompting
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import serve_t2i, serve_text, text_frames, train
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops import _build
from mmada_tpu_torch.prompting.universal import SpecialIds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mmada_tpu_torch")


def _tiny_special(vocab, cls):
    t = vocab.text_vocab_size
    return cls(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
               som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=vocab.bos_token_id,
               eos=vocab.eos_token_id)


@pytest.fixture(scope="module")
def models():
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, n_kv_heads=2)
    jmodel = JaxMMadaModel.init(jax.random.key(11), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=tiny_layout())


@pytest.fixture(scope="module")
def masked_models(models):
    """The same weights with `attention_bias_enabled=True`: the frames'
    attention masks reach attention as a bias."""
    jmodel, model = models
    return (dataclasses.replace(jmodel, cfg=dataclasses.replace(jmodel.cfg,
                                                                attention_bias_enabled=True)),
            dataclasses.replace(model, cfg=dataclasses.replace(model.cfg,
                                                               attention_bias_enabled=True)))


PROMPTS = ["hello", "world", "a longer prompt"]


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_serve_text_matches_jax(models, cfg_scale):
    """Three requests (two share a frame length, one batch each length):
    each answer equals the JAX model's on the same BOS-first frame."""
    jmodel, model = models
    kw = dict(gen_length=16, steps=8, block_length=8, temperature=0.0, cfg_scale=cfg_scale)
    answers = serve_text(model, PROMPTS, device="cpu", **kw)
    assert len(answers) == 3
    for frame, ans in zip(text_frames(model, PROMPTS), answers):
        assert frame[0] == model.vocab.bos_token_id
        want = jmodel.generate(jnp.asarray([frame], jnp.int32), **kw)
        np.testing.assert_array_equal(ans.numpy(), np.asarray(want)[0, len(frame):])
        assert (ans != model.vocab.mask_token_id).all()


def test_serve_text_batches_by_length(models, monkeypatch):
    _, model = models
    batches = []
    real = MMadaModel.generate

    def spy(self, prompt, **kw):
        batches.append(tuple(prompt.shape))
        return real(self, prompt, **kw)

    monkeypatch.setattr(MMadaModel, "generate", spy)
    serve_text(model, PROMPTS, device="cpu", gen_length=8, steps=4, block_length=8)
    assert sorted(batches) == [(1, 16), (2, 6)]


def test_serve_t2i_matches_jax(models):
    """Three t2i requests, greedy with CFG: codes equal the JAX model's on
    the frames the JAX prompting builds."""
    _serve_t2i_against_jax(*models)


def test_serve_t2i_masked_matches_jax(masked_models):
    """As above with `attention_bias_enabled=True`: the padded prompts and
    the uncond frames attend through the mask bias, in both packages."""
    _serve_t2i_against_jax(*masked_models)


def _serve_t2i_against_jax(jmodel, model):
    n, max_text_len = 16, 12
    kw = dict(temperature=0.0, timesteps=6, guidance_scale=2.0, num_vq_tokens=n)
    codes = serve_t2i(model, PROMPTS, special_ids=_tiny_special(model.vocab, SpecialIds),
                      device="cpu", max_text_len=max_text_len, greedy=True, **kw)
    assert codes.shape == (3, n)
    jvocab = jmodel.vocab
    prompting = JaxPrompting(JaxByteTokenizer(), _tiny_special(jvocab, JaxSpecialIds),
                             max_text_len=max_text_len)
    ids, attn = prompting.t2i_gen(PROMPTS, np.full((3, n), jvocab.mask_token_id))
    un_ids, un_attn = prompting.t2i_gen_uncond(3, n, jvocab.mask_token_id)
    want = jmodel.t2i_generate(jnp.asarray(ids), uncond_input_ids=jnp.asarray(un_ids),
                               attention_mask=jnp.asarray(attn),
                               uncond_attention_mask=jnp.asarray(un_attn),
                               key=jax.random.key(0), greedy=True, **kw)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))


def test_prompting_layouts_match_jax():
    """The port's copy of the text/t2i/mmu frame builders equals the JAX one."""
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, UniversalPrompting

    vocab, jvocab = tiny_layout(text_vocab_size=300), jax_tiny_layout(text_vocab_size=300)
    sp = dataclasses.replace(_tiny_special(vocab, SpecialIds), end_header=290)
    jsp = dataclasses.replace(_tiny_special(jvocab, JaxSpecialIds), end_header=290)
    up = UniversalPrompting(ByteTokenizer(), sp, max_text_len=10)
    jup = JaxPrompting(JaxByteTokenizer(), jsp, max_text_len=10)
    texts = ["hi", "a much longer caption that gets cut", "", "x" + chr(290 - 16) + "yz"]
    img = np.arange(4 * 6).reshape(4, 6) + 200
    for got, want in [
        (up.t2i_gen(texts, img), jup.t2i_gen(texts, img)),
        (up.t2i_gen_uncond(4, 6, 299), jup.t2i_gen_uncond(4, 6, 299)),
        (up.lm(texts, 12), jup.lm(texts, 12)),
        (up.lm_chat(texts, 12), jup.lm_chat(texts, 12)),
        (up.t2i(texts, img, img, dropout=False), jup.t2i(texts, img, img, dropout=False)),
        (up.mmu(img, texts), jup.mmu(img, texts)),
        (up((img, texts), "mmu"), jup((img, texts), "mmu")),
    ]:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_serve_t2i_sampled_codes_in_range(models):
    _, model = models
    codes = serve_t2i(model, PROMPTS, special_ids=_tiny_special(model.vocab, SpecialIds),
                      device="cpu", num_vq_tokens=16, max_text_len=12, timesteps=4,
                      guidance_scale=3.5, temperature=1.0, seed=3)
    assert codes.shape == (3, 16)
    assert ((codes >= 0) & (codes < model.vocab.image_codebook_size)).all()


def test_train_entry_on_cpu(models):
    """`train` on the CPU: three steps over two cycled raw batches (t2i, lm
    and mmu flows, images as VQ codes), finite metrics each step, and the
    model's own weights updated in place."""
    _, served = models
    params = {k: ({n: t.clone() for n, t in v.items()} if k == "blocks" else v.clone())
              for k, v in served.params.items()}   # the fixture's weights stay as they are
    model = MMadaModel(cfg=served.cfg, params=params, vocab=served.vocab, remat="full")
    before = model.params["blocks"]["q_proj"].clone()
    rng = np.random.default_rng(0)

    def flows(n):
        return {"t2i_flow": {"input_ids": PROMPTS[:n], "image_codes": rng.integers(0, 64, (n, 16))},
                "lm_flow": {"input_ids": PROMPTS[:2]},
                "mmu_flow": {"input_ids": PROMPTS[:n], "image_codes": rng.integers(0, 64, (n, 16))}}

    trainer = train(model, [flows(3), flows(3)], steps=3, device="cpu",
                    special_ids=_tiny_special(model.vocab, SpecialIds), max_text_len=12,
                    training=dict(batch_size_t2i=3, batch_size_lm=2, batch_size_mmu=3,
                                  loss_chunk=16),
                    optimizer={"params": {"max_grad_norm": 1.0}},
                    lr_scheduler={"scheduler": "constant", "params": {"learning_rate": 1e-3}})
    assert [h["step"] for h in trainer.history] == [1, 2, 3]
    for h in trainer.history:
        assert all(np.isfinite(v) for v in h.values()) and h["skipped_nonfinite"] == 0
    assert int(trainer.state.step) == 3
    assert not torch.equal(model.params["blocks"]["q_proj"], before)


def test_masked_t2i_and_train_entry_on_cpu(masked_models):
    """`serve_t2i` and `train` on a model with `attention_bias_enabled=True`
    need no new argument: the frames' masks (padded prompts, t2i_masks) go
    through the biased attention, answers are in range and the train steps
    finite, and the masks change what the model computes."""
    _, served = masked_models
    params = {k: ({n: t.clone() for n, t in v.items()} if k == "blocks" else v.clone())
              for k, v in served.params.items()}
    model = MMadaModel(cfg=served.cfg, params=params, vocab=served.vocab, remat="full")
    sp = _tiny_special(model.vocab, SpecialIds)
    kw = dict(special_ids=sp, device="cpu", num_vq_tokens=16, max_text_len=12, timesteps=4,
              guidance_scale=2.0, temperature=0.0, greedy=True)
    codes = serve_t2i(model, PROMPTS, **kw)
    assert codes.shape == (3, 16)
    assert ((codes >= 0) & (codes < model.vocab.image_codebook_size)).all()
    rng = np.random.default_rng(1)
    flows = {"t2i_flow": {"input_ids": PROMPTS, "image_codes": rng.integers(0, 64, (3, 16))},
             "lm_flow": {"input_ids": PROMPTS[:2]},
             "mmu_flow": {"input_ids": PROMPTS, "image_codes": rng.integers(0, 64, (3, 16))}}
    trainer = train(model, [flows], steps=2, device="cpu", special_ids=sp, max_text_len=12,
                    training=dict(batch_size_t2i=3, batch_size_lm=2, batch_size_mmu=3,
                                  loss_chunk=16, max_grad_norm=1.0),
                    lr_scheduler={"scheduler": "constant", "params": {"learning_rate": 1e-3}})
    batch = trainer.prepare_batch(flows)
    assert (batch["t2i_masks"] == 0).any()   # the caption pads are masked out
    for h in trainer.history:
        assert all(np.isfinite(v) for v in h.values()) and h["skipped_nonfinite"] == 0
    assert int(trainer.state.step) == 2


def test_entry_points_never_fall_back_to_cpu(models, monkeypatch):
    """Without an explicit device the port wants the card; with no card it
    raises instead of running on the CPU."""
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llada.tiny_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_text(model, PROMPTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_t2i(model, PROMPTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(model, [], steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        MMadaModel.init(cfg, tiny_layout())
    with pytest.raises(RuntimeError, match="CUDA"):
        llada.init_params(cfg)


def test_serving_rejects_weights_on_another_device(models):
    _, model = models
    with pytest.raises(ValueError, match="model weights"):
        serve_text(model, PROMPTS, device="meta")


def test_port_imports_without_jax_yaml_or_the_jax_package():
    """In a fresh interpreter where jax, yaml, PIL and mmada_tpu cannot be
    imported, the port imports, runs a tiny forward, takes a train step,
    runs attention forward and backward at 4,224 tokens (the long tier),
    runs an int4 forward and a W8A8 forward (`entry.quantize`), encodes
    and decodes an image with a tiny MAGVIT-v2, and answers one request
    through the serving engine (`serve.engine`, `utils.flops`); `app_torch`,
    `train_torch` and the training modules (data readers, checkpoint
    manager, EMA, remat_auto, validation hooks) import too, without
    pyarrow; the mesh modules (`core/mesh`, `parallel/`) import and a
    one-rank mesh serves the model's logits."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'yaml', 'PIL', 'transformers', 'safetensors',"
        " 'mmada_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch, mmada_tpu_torch\n"
        "import mmada_tpu_torch.entry, mmada_tpu_torch.checkpoints.from_jax\n"
        "from mmada_tpu_torch.models import llada\n"
        "from mmada_tpu_torch.training import losses, lr_schedules, masking, optimizers\n"
        "from mmada_tpu_torch.training import train_step, trainer\n"
        "cfg = llada.tiny_config()\n"
        "p = llada.init_params(cfg, device='cpu', generator=torch.Generator().manual_seed(0))\n"
        "out = llada.forward(p, cfg, torch.zeros(1, 8, dtype=torch.long))\n"
        "assert out.shape == (1, 8, cfg.vocab_size) and torch.isfinite(out).all()\n"
        "from mmada_tpu_torch.core.vocab import tiny_layout\n"
        "from mmada_tpu_torch.models.mmada import MMadaModel\n"
        "vocab = tiny_layout()\n"
        "cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size)\n"
        "model = MMadaModel.init(cfg, vocab, device='cpu', remat=True,\n"
        "                        generator=torch.Generator().manual_seed(0))\n"
        "opt = optimizers.AdamW(1e-3)\n"
        "state = train_step.TrainState.create(model.params, opt)\n"
        "sc = train_step.StepConfig(batch_size_t2i=0, batch_size_lm=2, batch_size_mmu=0,\n"
        "                           max_seq_length=4, loss_chunk=4)\n"
        "ids = torch.randint(3, 200, (2, 10), generator=torch.Generator().manual_seed(1))\n"
        "state, m = train_step.make_train_step(model, opt, sc)(\n"
        "    state, {'lm_input_ids': ids, 'lm_labels': ids}, torch.Generator().manual_seed(2))\n"
        "assert int(state.step) == 1 and torch.isfinite(m['loss'])\n"
        "import dataclasses\n"
        "mcfg = dataclasses.replace(cfg, attention_bias_enabled=True)\n"
        "masked = MMadaModel.init(mcfg, vocab, device='cpu', remat=True,\n"
        "                         generator=torch.Generator().manual_seed(0))\n"
        "mask = torch.ones(2, 10, dtype=torch.long)\n"
        "mask[0, :3] = 0\n"
        "out = masked.forward(ids, attention_mask=mask)\n"
        "assert torch.isfinite(out).all()\n"
        "assert not torch.allclose(out[0], masked.forward(ids)[0])\n"
        "sc = train_step.StepConfig(batch_size_t2i=2, batch_size_lm=0, batch_size_mmu=0,\n"
        "                           max_seq_length=4, loss_chunk=4)\n"
        "t2i = ids.clone()\n"
        "t2i[:, 5:9] = vocab.image_offset + 3\n"
        "state = train_step.TrainState.create(masked.params, opt)\n"
        "state, m = train_step.make_train_step(masked, opt, sc)(\n"
        "    state, {'t2i_input_ids': t2i, 't2i_masks': mask}, torch.Generator().manual_seed(3))\n"
        "assert int(state.step) == 1 and torch.isfinite(m['loss'])\n"
        "from mmada_tpu_torch.ops.attention import bidirectional_attention\n"
        "g = torch.Generator().manual_seed(4)\n"
        "q, k = (torch.randn(1, 2, 4224, 64, generator=g).requires_grad_() for _ in range(2))\n"
        "sin, cos = llada.rope_sin_cos(4224, 64, 10000.0, device='cpu')\n"
        "out = bidirectional_attention(q, k, k, rope_sin=sin, rope_cos=cos)\n"
        "dq, dk = torch.autograd.grad(out.square().sum(), (q, k))\n"
        "assert out.shape == q.shape and all(torch.isfinite(t).all() for t in (out, dq, dk))\n"
        "from mmada_tpu_torch.ops import quantization, smoothquant, int4_matmul\n"
        "qcfg = llada.tiny_config(vocab_size=384, d_model=128, mlp_hidden_size=256)\n"
        "qmodel = MMadaModel.init(qcfg, vocab, device='cpu',\n"
        "                         generator=torch.Generator().manual_seed(5))\n"
        "for scheme, cls in (('int4', quantization.Int4Tensor), ('w8a8', quantization.W8A8Tensor)):\n"
        "    qm = mmada_tpu_torch.entry.quantize(qmodel, scheme)\n"
        "    assert isinstance(qm.params['blocks']['ff_out'], cls)\n"
        "    out = qm.forward(ids)\n"
        "    assert out.shape == (2, 10, 384) and torch.isfinite(out).all()\n"
        "from mmada_tpu_torch.models import magvit2\n"
        "from mmada_tpu_torch.checkpoints import magvit_import\n"
        "vcfg = magvit2.tiny_vqgan(16)\n"
        "vq = magvit2.init_magvit2(vcfg, device='cpu', generator=torch.Generator().manual_seed(6))\n"
        "codes = magvit2.get_code(vq, vcfg, torch.rand(1, 16, 16, 3, generator=g) * 2 - 1)\n"
        "assert codes.shape == (1, 64) and 0 <= int(codes.min()) <= int(codes.max()) < 32\n"
        "img = mmada_tpu_torch.entry.decode_images(vq, vcfg, codes, device='cpu')\n"
        "assert img.shape == (1, 16, 16, 3) and img.dtype == torch.uint8\n"
        "from mmada_tpu_torch.core.config import parse_kv_cache\n"
        "out = model.generate(ids[:, :6], gen_length=8, steps=4, block_length=4,\n"
        "                     block_kv_cache=parse_kv_cache('int8'), cache_refresh_every=1,\n"
        "                     parallel_threshold=0.9)\n"
        "assert out.shape == (2, 14) and (out != vocab.mask_token_id).all()\n"
        "from mmada_tpu_torch.serve import engine\n"
        "from mmada_tpu_torch.utils import flops\n"
        "eng = engine.ServingEngine(model, min_chunk_device_ms=0).start()\n"
        "st = engine.TextSettings(gen_length=8, steps=4, block_length=4, segment_steps=1)\n"
        "got = eng.submit_text(ids[0, :6].numpy(), st).result(60)\n"
        "eng.stop()\n"
        "want = model.generate(ids[:1, :6], gen_length=8, steps=4, block_length=4)[0]\n"
        "assert (torch.as_tensor(got) == want).all() and eng.stats['chunks'] == 4\n"
        "assert flops.forward_matmul_flops_per_token(cfg, 14, 4, cfg.vocab_size) > 0\n"
        "import chip_smoke, profile_cached, app_torch, train_torch\n"
        "from mmada_tpu_torch.core import mesh\n"
        "from mmada_tpu_torch.parallel import (collectives, grads, pipeline, ring_attention,\n"
        "                                      sharding, tp_attention)\n"
        "m = mesh.make_mesh(fsdp=-1, device='cpu')\n"
        "sharded = dataclasses.replace(model, mesh=m, params=sharding.shard_params(\n"
        "    model.params, sharding.model_specs(model.cfg, m), m))\n"
        "assert torch.equal(sharded.forward(ids), model.forward(ids))\n"
        "from mmada_tpu_torch.data import (captions, combined, imagenet, native, synthetic,\n"
        "                                  text, vqa, webdataset)\n"
        "from mmada_tpu_torch.checkpoints import manager\n"
        "from mmada_tpu_torch.training import ema, remat_auto, validation\n"
        "from mmada_tpu_torch.utils import logging as _logging, meters\n"
        "assert 'pyarrow' not in sys.modules\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-B", "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|yaml|PIL)\b|from\s+(jax|yaml|PIL)\b"
    r"|import\s+mmada_tpu(\.|\s|$)|from\s+mmada_tpu(\.|\s))",
    re.MULTILINE,
)


def _check_imports_only_inside_functions(name: str) -> None:
    """`name` imports nothing of JAX or the JAX package, and PIL and yaml
    only inside functions."""
    with open(os.path.join(REPO, name)) as f:
        src = f.read()
    imports = re.findall(r"^(\s*)(?:import\s+([\w.]+)|from\s+([\w.]+)\s+import)", src,
                         re.MULTILINE)
    assert imports
    for indent, a, b in imports:
        top = (a or b).split(".")[0]
        assert top not in ("jax", "jaxlib", "mmada_tpu"), a or b
        if top in ("PIL", "yaml"):
            assert indent, a or b


def test_app_torch_imports_no_jax_and_pil_only_inside_functions():
    """The HTTP front end imports nothing of JAX or the JAX package, and
    PIL only inside the functions that need it (as the command lines do)."""
    _check_imports_only_inside_functions("app_torch.py")


def test_train_torch_imports_no_jax_and_pil_yaml_only_inside_functions():
    """The training command line: no JAX, PIL and yaml inside functions."""
    _check_imports_only_inside_functions("train_torch.py")


def test_source_scan_finds_no_forbidden_import():
    files = [os.path.join(REPO, name) for name in ("chip_smoke.py", "profile_cached.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    hits = []
    for path in files:
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert hits == []


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("flash_attention_fwd", "/tmp/out.so", nvcc="nvcc")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd and "-std=c++17" in cmd
    assert cmd[-1].endswith(os.path.join("csrc", "flash_attention_fwd.cu"))
    assert _build.sources() == ["attention_generic", "attention_wide", "attention_wide_bwd",
                                "flash_attention_bwd", "flash_attention_fwd",
                                "flash_attention_long", "int4_matmul", "int4_matmul_f32"]
    # the C sources include CUDA headers only (no torch/extension.h): seconds to build
    for name in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            includes = re.findall(r"#include\s*[<\"]([^>\"]+)", f.read())
        assert all(not i.startswith(("torch", "ATen", "cutlass")) for i in includes), name


def test_build_dir_is_inside_the_package_and_gitignored():
    assert os.path.dirname(_build.BUILD_DIR) == PORT
    probe = os.path.join(os.path.relpath(_build.BUILD_DIR, REPO), "libx.so")
    res = subprocess.run(["git", "check-ignore", "-q", probe], cwd=REPO,
                         capture_output=True, timeout=60)
    if res.returncode == 128:  # a checkout without git metadata
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert "mmada_tpu_torch/_kernels_build/" in f.read().split()
    else:
        assert res.returncode == 0, res.stderr


def test_library_hash_follows_the_sources():
    path = _build.library_path("flash_attention_fwd")
    assert path.startswith(_build.BUILD_DIR + os.sep) and path.endswith(".so")
    assert path == _build.library_path("flash_attention_fwd")


def test_missing_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
