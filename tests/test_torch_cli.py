"""The port's command lines against the JAX package's, on the CPU.

* `generate_torch.main` against `generate.main` on one tiny-width fp32
  checkpoint that both load (the MMaDA-8B vocab, 2 layers, d_model 64):
  the printed answers are equal.
* `inference_t2i_torch` and `inference_mmu_torch` on `configs/tiny_test.yaml`:
  JAX's `load_all` weights, carried over with `from_jax`, through the port's
  `run`; the images equal the PNGs of JAX's `main` and the printed answers
  are equal. Categorical draws differ between the packages (threefry and
  Philox), so both t2i samplers are made greedy (`greedy=True`) at
  temperature 0 and their codes held equal; the images are the port's
  decode of them, within one level of JAX's PNGs (the decode bar of
  `test_torch_magvit.py`). The MMU CLIs decode at temperature 0 as they are.
* In a fresh interpreter where jax, yaml, PIL, transformers, safetensors and
  mmada_tpu cannot be imported, a checkpoint written by the port loads
  (`from_pretrained`) and `generate_torch.main` answers from dotted
  overrides alone.
* The three scripts import no jax and nothing of `mmada_tpu`, and yaml and
  PIL only inside functions.
"""

import os
import re
import subprocess
import sys

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # the tokenizer fallbacks look at local files only
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import generate
import generate_torch
import inference_mmu
import inference_mmu_torch
import inference_t2i
import inference_t2i_torch
from mmada_tpu.core.config import load_config as jax_load_config
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu.serve.loader import load_all as jax_load_all
from mmada_tpu_torch.checkpoints.from_jax import magvit2_from_jax, params_from_jax
from mmada_tpu_torch.checkpoints.hf_import import export_pretrained
from mmada_tpu_torch.core.precision import FP32
from mmada_tpu_torch.core.vocab import MMADA_8B
from mmada_tpu_torch.entry import decode_images
from mmada_tpu_torch.models import llada, magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer
from mmada_tpu_torch.serve import loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("generate_torch.py", "inference_t2i_torch.py", "inference_mmu_torch.py",
           "eval_t2m_torch.py")
TINY = "configs/tiny_test.yaml"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny-width fp32 checkpoint with the MMaDA-8B vocab, as the port writes it."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    cfg = llada.LLaDAConfig(d_model=64, n_heads=4, n_layers=2, mlp_hidden_size=128,
                            vocab_size=MMADA_8B.total_vocab_size,
                            embedding_size=MMADA_8B.total_vocab_size, max_sequence_length=512,
                            rope_theta=10000.0)
    params = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    export_pretrained(d, params, cfg, MMADA_8B, max_shard_bytes=40 * 2**20)
    return d


@pytest.fixture
def printed_ids(monkeypatch):
    """Both packages' `ByteTokenizer.decode` print the ids it is given: a
    random model's answers are mostly outside the printable bytes."""
    for cls in (JaxByteTokenizer, ByteTokenizer):
        monkeypatch.setattr(cls, "decode", lambda self, ids: repr([int(i) for i in ids]))


def test_generate_torch_prints_what_generate_prints(checkpoint, capsys, printed_ids):
    argv = [f"model.mmada.pretrained_model_path={checkpoint}", "training.mixed_precision=fp32",
            "prompt=Name three colors of a rainbow", "gen_length=16", "steps=8",
            "block_length=8"]
    assert generate.main(argv + ["parallel.serving=none"]) == 0
    want = capsys.readouterr().out
    assert generate_torch.main(argv + ["device=cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(eval(want)) > 0


def _carried_over(argv):
    """JAX's `load_all` of `argv`, and the same weights in the port's
    `Loaded` (its tokenizer, prompting and vocab from the port's builders)."""
    jcfg = jax_load_config(cli_args=argv)
    jmodel, jvq, _, _, _, _ = jax_load_all(jcfg)
    cfg = generate_torch.read_config(argv)
    tokenizer = loader.build_text_tokenizer(cfg)
    vocab = loader.build_vocab(cfg)
    pcfg = llada.LLaDAConfig(**{f: getattr(jmodel.cfg, f)
                                for f in llada.LLaDAConfig.__dataclass_fields__})
    model = MMadaModel(cfg=pcfg, params=params_from_jax(jax.device_get(jmodel.params), pcfg,
                                                        device="cpu"),
                       vocab=vocab, policy=FP32)
    vq_cfg = magvit2.tiny_vqgan()
    vq = magvit2_from_jax(jax.device_get(jvq), vq_cfg, device="cpu")
    return cfg, loader.Loaded(model, vq, vq_cfg, tokenizer,
                              loader.build_prompting(cfg, tokenizer, vocab), vocab)


def _greedy(cls, monkeypatch) -> list:
    """`cls.t2i_generate` made greedy; returns the list its codes go into."""
    inner, codes = cls.t2i_generate, []

    def greedy(self, *args, **kw):
        kw["greedy"] = True
        out = inner(self, *args, **kw)
        codes.append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, "t2i_generate", greedy)
    return codes


def test_t2i_cli_gives_jax_images(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red fox\n\nan oil painting of a lighthouse\na cat\n a dog \n")
    argv = [f"config={TINY}", f"validation_prompts_file={prompts}", "batch_size=2",
            "generation_timesteps=4", "generation_temperature=0", "guidance_scale=1.5",
            f"output_dir={tmp_path / 'jax'}", "parallel.serving=none"]
    jax_codes = _greedy(JaxMMadaModel, monkeypatch)
    assert inference_t2i.main(argv) == 0
    jax_out = capsys.readouterr().out
    _greedy(MMadaModel, monkeypatch)
    cfg, loaded = _carried_over(argv + ["device=cpu"])
    texts = inference_t2i_torch.read_prompts(cfg)
    codes, images = inference_t2i_torch.run(cfg, loaded, texts)
    assert texts == ["a red fox", "an oil painting of a lighthouse", "a cat", "a dog"]
    assert codes.shape == (4, 64) and images.shape == (4, 16, 16, 3)
    np.testing.assert_array_equal(codes.numpy(), np.concatenate(jax_codes))
    # the port's pixels are its decode's bit for bit; pixel values within the
    # decode bar of JAX's can land on the other side of an integer, so JAX's
    # PNGs are held within one level (test_torch_magvit's bar)
    np.testing.assert_array_equal(images.numpy(), decode_images(
        loaded.vq, loaded.vq_cfg, codes, device="cpu").numpy())
    for i in range(4):
        with Image.open(tmp_path / "jax" / f"{i:04d}.png") as img:
            png = np.asarray(img).astype(int)
        assert np.abs(images[i].numpy().astype(int) - png).max() <= 1
    assert jax_out.count(".png: ") == 4


def test_mmu_cli_prints_jax_answers(tmp_path, monkeypatch, capsys, printed_ids):
    monkeypatch.chdir(REPO)
    rng = np.random.default_rng(0)
    for name, size in (("b.png", (24, 16)), ("a.jpg", (16, 16)), ("notes.txt", None)):
        if size is None:
            (tmp_path / name).write_text("not an image")
        else:
            Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(tmp_path / name)
    argv = [f"config={TINY}", f"mmu_image_root={tmp_path}", "question=What is in it?",
            "max_new_tokens=8", "steps=4", "parallel.serving=none"]
    for extra in ([], ["fast=true", "block_length=4"]):
        assert inference_mmu.main(argv + extra) == 0
        want = capsys.readouterr().out
        cfg, loaded = _carried_over(argv + extra + ["device=cpu"])
        names, pixels = inference_mmu_torch.read_images(str(tmp_path), 16)
        assert names == ["a.jpg", "b.png"] and pixels.shape == (2, 16, 16, 3)
        answers = inference_mmu_torch.run(cfg, loaded, pixels)
        got = "".join(f"=== {n}\n{generate_torch.answer_text(loaded, a)}\n\n"
                      for n, a in zip(names, answers))
        assert got == want


def write_tiny_clip(path, image_size=28):
    """A tiny random CLIP checkpoint (`CLIPModel.save_pretrained`) with a
    processor: a letters-only BPE vocab (no merges; EOT the largest id, as
    the legacy pooling expects) and a 28-px image processor."""
    import json

    from transformers import CLIPImageProcessor, CLIPProcessor, CLIPTokenizer

    from test_torch_eval_clip import tiny_clip

    model, _ = tiny_clip()
    model.save_pretrained(str(path))
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {c: i for i, c in enumerate(letters)}
    vocab.update({c + "</w>": 26 + i for i, c in enumerate(letters)})
    vocab.update({"<|startoftext|>": 97, "<|endoftext|>": 98})
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    tok = CLIPTokenizer(str(path / "vocab.json"), str(path / "merges.txt"), model_max_length=16)
    images = CLIPImageProcessor(size={"shortest_edge": image_size},
                                crop_size={"height": image_size, "width": image_size})
    CLIPProcessor(image_processor=images, tokenizer=tok).save_pretrained(str(path))
    return str(path)


def test_clis_refuse_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """`quantative=true` scores the images (it was refused until the eval
    modules were ported): with a tiny CLIP checkpoint its `quantative.json`
    is the port's scorer on the PNGs it wrote (and within 1e-4 of the
    transformers CLIPModel's scores on them); with no checkpoint configured
    it writes `{}`. `segment_steps` runs the segmented sampler, which
    answers as the monolithic one."""
    import json

    from mmada_tpu_torch.eval.image_quality import load_scorer

    monkeypatch.chdir(REPO)
    clip_dir = write_tiny_clip(tmp_path / "clip")
    prompts = ["a red fox", "a cat"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n")
    out = tmp_path / "t2i"
    t2i = [f"config={TINY}", "device=cpu", "generation_timesteps=2",
           f"validation_prompts_file={tmp_path / 'prompts.txt'}", "quantative=true",
           "batch_size=2"]
    assert inference_t2i_torch.main(t2i + [f"eval.clip_dir={clip_dir}",
                                           f"output_dir={out}"]) == 0
    assert "quantative: {'clip_score_mean'" in capsys.readouterr().out
    got = json.loads((out / "quantative.json").read_text())
    pixels = np.stack([np.asarray(Image.open(out / f"{i:04d}.png")) for i in range(2)])
    pixels = pixels.astype(np.float32) / 127.5 - 1.0
    assert got == load_scorer(clip_dir, device="cpu").quantitative_images(pixels, prompts)
    cross = load_scorer(clip_dir, backend="transformers").quantitative_images(pixels, prompts)
    np.testing.assert_allclose(got["clip_score"], cross["clip_score"], rtol=1e-4, atol=1e-4)
    assert inference_t2i_torch.main(t2i + [f"output_dir={tmp_path / 'none'}"]) == 0
    assert json.loads((tmp_path / "none" / "quantative.json").read_text()) == {}
    assert "(scoring models unavailable)" in capsys.readouterr().out
    argv = [f"config={TINY}", "device=cpu", "gen_length=16", "steps=8", "block_length=8"]
    assert generate_torch.main(argv) == 0
    want = capsys.readouterr().out
    assert generate_torch.main(argv + ["segment_steps=3"]) == 0
    assert capsys.readouterr().out == want
    assert inference_mmu_torch.main([f"config={TINY}", f"mmu_image_root={tmp_path}",
                                     "device=cpu"]) == 1


def test_generate_torch_runs_without_jax_yaml_pil_transformers_or_safetensors(checkpoint):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'yaml', 'PIL', 'transformers', 'safetensors',"
        " 'mmada_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch, generate_torch, inference_t2i_torch, inference_mmu_torch\n"
        "from mmada_tpu_torch.core.precision import FP32\n"
        "from mmada_tpu_torch.core.vocab import MMADA_8B\n"
        "from mmada_tpu_torch.checkpoints.hf_import import export_pretrained, state_dict_views\n"
        "from mmada_tpu_torch.models.mmada import MMadaModel\n"
        f"src = MMadaModel.from_pretrained({checkpoint!r}, MMADA_8B, device='cpu',"
        " dtype=torch.float32, policy=FP32)\n"
        "d = sys.argv[1]\n"
        "export_pretrained(d, src.params, src.cfg, MMADA_8B)\n"
        "model = MMadaModel.from_pretrained(d, MMADA_8B, device='cpu', dtype=torch.float32,"
        " policy=FP32)\n"
        "views = state_dict_views(src.params)\n"
        "assert all(torch.equal(v, state_dict_views(model.params)[k]) for k, v in views.items())\n"
        "sys.exit(generate_torch.main([f'model.mmada.pretrained_model_path={d}', 'device=cpu',"
        " 'training.mixed_precision=fp32', 'gen_length=8', 'steps=4', 'block_length=8']))\n"
    )
    out = os.path.join(os.path.dirname(checkpoint), "rewritten")
    res = subprocess.run([sys.executable, "-B", "-c", code, out], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "falling back to ByteTokenizer" in res.stderr


_IMPORT = re.compile(r"^(\s*)(?:import\s+([\w.]+)|from\s+([\w.]+)\s+import)", re.MULTILINE)


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_no_jax_and_yaml_or_pil_only_inside_functions(script):
    with open(os.path.join(REPO, script)) as f:
        imports = [(m.group(1), m.group(2) or m.group(3)) for m in _IMPORT.finditer(f.read())]
    assert imports
    for indent, module in imports:
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "mmada_tpu"), (script, module)
        if top in ("yaml", "PIL"):
            assert indent, (script, module)
