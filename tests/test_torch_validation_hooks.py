"""The port's validation hooks (`mmada_tpu_torch/training/validation.py`)
against JAX's (`mmada_tpu/training/validation.py`) on the same carried-over
weights (a tiny backbone and a small MAGVIT-v2), and the Trainer's cadence
that runs them (`train_torch`, PIL writing the PNGs):

* the chat and understanding hooks decode greedily: answers token-exact,
  `chat.jsonl` / `mmu_answers.jsonl` equal;
* the t2i hook draws from JAX's threefry and the port's Philox streams,
  which differ, so both samplers are made greedy (`greedy=True`, as
  `tests/test_torch_cli.py` does): codes equal, pixels within the decode
  bar of `tests/test_torch_magvit.py`, `t2i_prompts.jsonl` equal;
* `visualize_predictions` masks by each package's random stream, so both
  maskings are replaced by one fixed pattern: recon and predicted pixels
  within the decode bar;
* `quantative_images` (the stage-4 CLIP / ImageReward summary) on the
  greedy t2i hook with one scorer for both: `quantative.json` alike;
* the same file names under `validation/step_{N}/`, and a failing hook
  logged with its traceback while training goes on.
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch

import train_torch
from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models import magvit2 as jax_magvit2
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu.prompting.universal import SpecialIds as JaxSpecialIds
from mmada_tpu.prompting.universal import UniversalPrompting as JaxPrompting
from mmada_tpu.training import masking as jax_masking
from mmada_tpu.training import validation as JV
from mmada_tpu_torch.checkpoints.from_jax import magvit2_from_jax, params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada, magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting
from mmada_tpu_torch.training import masking
from mmada_tpu_torch.training import validation as V

PIXEL_TOL = dict(atol=5e-4, rtol=1e-3)   # tests/test_torch_magvit.py's decode bar
SP = dict(soi=230, eoi=231, t2i=232, mmu=233, r2i=234, t2m=235, som=236, eom=237, bos=1, eos=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads cost more than they
    save, most of all beside other test workers; the setting is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, vq params, vq cfg, prompting), (the port's, same weights)."""
    jvocab = jax_tiny_layout(text_vocab_size=256, image_codebook_size=32)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jmodel = JaxMMadaModel(cfg=jcfg, params=jax_llada.init_params(jax.random.key(0), jcfg),
                           vocab=jvocab)
    vq_kw = dict(ch=32, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1), dec_ch_mult=(1, 2),
                 dec_num_res_blocks=(1, 1), attn_resolutions=(8,), resolution=16,
                 z_channels=5, num_groups=32)
    jvq_cfg = jax_magvit2.VQGANConfig(**vq_kw)
    jvq = jax_magvit2.init_magvit2(jax.random.key(1), jvq_cfg)
    jprompting = JaxPrompting(JaxByteTokenizer(), JaxSpecialIds(
        pad=jvocab.pad_token_id, **SP), max_text_len=8, cond_dropout_prob=0.0)

    vocab = tiny_layout(text_vocab_size=256, image_codebook_size=32)
    cfg = llada.LLaDAConfig(**{f: getattr(jcfg, f) for f in llada.LLaDAConfig.__dataclass_fields__})
    model = MMadaModel(cfg=cfg, params=params_from_jax(jax.device_get(jmodel.params), cfg,
                                                       device="cpu"), vocab=vocab)
    vq_cfg = magvit2.VQGANConfig(**vq_kw)
    vq = magvit2_from_jax(jax.device_get(jvq), vq_cfg, device="cpu")
    prompting = UniversalPrompting(ByteTokenizer(), SpecialIds(pad=vocab.pad_token_id, **SP),
                                   max_text_len=8, cond_dropout_prob=0.0)
    return (jmodel, jvq, jvq_cfg, jprompting), (model, vq, vq_cfg, prompting)


def _jax_saved(monkeypatch):
    """JAX's `_save_image` records what it would write: (name, uint8)."""
    saved = []
    monkeypatch.setattr(JV, "_save_image", lambda path, px: saved.append(
        (path.rsplit("/", 1)[-1], np.clip((px + 1.0) * 127.5, 0, 255).astype(np.uint8))))
    return saved


def _writer():
    written = []
    return written, lambda path, arr: written.append((path.rsplit("/", 1)[-1], arr))


def _files(root, step):
    return sorted(p.name for p in (root / "validation" / f"step_{step}").iterdir())


def _greedy(cls, monkeypatch) -> list:
    inner, codes = cls.t2i_generate, []

    def greedy(self, *args, **kw):
        kw["greedy"] = True
        out = inner(self, *args, **kw)
        codes.append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, "t2i_generate", greedy)
    return codes


def test_generate_images_matches_jax(pair, tmp_path, monkeypatch):
    (jmodel, jvq, jvq_cfg, jprompting), (model, vq, vq_cfg, prompting) = pair
    jsaved = _jax_saved(monkeypatch)
    jcodes, codes = _greedy(JaxMMadaModel, monkeypatch), _greedy(MMadaModel, monkeypatch)
    prompts = ["a red fox", "a lamp at dusk"]
    want = JV.generate_images(jmodel, jvq, jvq_cfg, jprompting, prompts, str(tmp_path / "j"), 7,
                              num_vq_tokens=64, timesteps=3)
    written, write = _writer()
    got = V.generate_images(model, vq, vq_cfg, prompting, prompts, str(tmp_path / "p"), 7,
                            write, num_vq_tokens=64, timesteps=3)
    np.testing.assert_array_equal(codes[0], jcodes[0])
    np.testing.assert_allclose(got, np.asarray(want), **PIXEL_TOL)
    assert [n for n, _ in written] == [n for n, _ in jsaved] == ["t2i_000.png", "t2i_001.png"]
    for (_, a), (_, b) in zip(written, jsaved):
        assert a.dtype == np.uint8 and np.abs(a.astype(int) - b).max() <= 1
    for name in ("t2i_prompts.jsonl",):
        assert (tmp_path / "p/validation/step_7" / name).read_text() == (
            tmp_path / "j/validation/step_7" / name).read_text()


def _scorers():
    """The same scorer for both packages: embeddings and rewards that are
    plain functions of the pixels and prompts (numpy)."""
    from mmada_tpu.eval.image_quality import ImageQualityScorer as JaxScorer
    from mmada_tpu_torch.eval.image_quality import ImageQualityScorer

    fns = dict(image_embed_fn=lambda px: np.asarray(px).reshape(len(px), -1)[:, ::97],
               text_embed_fn=lambda texts: np.stack([np.linspace(-1, 1, 8)[:, None].repeat(
                   (3 * 16 * 16 + 96) // 97, 1)[len(t) % 8] for t in texts]),
               reward_fn=lambda px, prompts: np.asarray(px).mean(axis=(1, 2, 3)))
    return JaxScorer(**fns), ImageQualityScorer(**fns)


@pytest.mark.parametrize("scored", [True, False])
def test_quantative_images_matches_jax(pair, tmp_path, monkeypatch, scored):
    """The stage-4 hook: the greedy t2i codes equal, the CLIP scores and the
    reward's mean within the decode bar, `quantative.json`'s keys equal;
    without a scorer both write `{}`."""
    (jmodel, jvq, jvq_cfg, jprompting), (model, vq, vq_cfg, prompting) = pair
    _jax_saved(monkeypatch)
    jcodes, codes = _greedy(JaxMMadaModel, monkeypatch), _greedy(MMadaModel, monkeypatch)
    jscorer, scorer = _scorers() if scored else (None, None)
    prompts = ["a red fox", "a lamp at dusk"]
    want = JV.quantative_images(jmodel, jvq, jvq_cfg, jprompting, prompts, jscorer,
                                str(tmp_path / "j"), 5, num_vq_tokens=64, timesteps=3)
    written, write = _writer()
    got = V.quantative_images(model, vq, vq_cfg, prompting, prompts, scorer, str(tmp_path / "p"),
                              5, write, num_vq_tokens=64, timesteps=3)
    np.testing.assert_array_equal(codes[0], jcodes[0])
    assert got.keys() == want.keys() == ({"clip_score_mean", "clip_score", "image_reward_mean"}
                                         if scored else set())
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **PIXEL_TOL)
    saved = json.loads((tmp_path / "p/validation/step_5/quantative.json").read_text())
    assert saved.keys() == json.loads(
        (tmp_path / "j/validation/step_5/quantative.json").read_text()).keys()
    assert _files(tmp_path / "p", 5) == _files(tmp_path / "j", 5)
    assert len(written) == 2


def _fixed_mask(ids):
    """Every third image position masked."""
    return (np.arange(ids.shape[1]) % 3 == 0)[None, :].repeat(ids.shape[0], 0)


def test_visualize_predictions_matches_jax(pair, tmp_path, monkeypatch):
    (jmodel, jvq, jvq_cfg, jprompting), (model, vq, vq_cfg, prompting) = pair
    import jax.numpy as jnp

    def jmask(key, ids, mask_id, **kw):
        m = jnp.asarray(_fixed_mask(np.asarray(ids)))
        return jnp.where(m, mask_id, ids), jnp.where(m, ids, -100), jnp.full(ids.shape[0], 1 / 3)

    def pmask(generator, ids, mask_id, **kw):
        m = torch.as_tensor(_fixed_mask(ids.numpy()))
        return (torch.where(m, mask_id, ids), torch.where(m, ids, -100),
                torch.full((ids.shape[0],), 1 / 3))

    monkeypatch.setattr(jax_masking, "mask_image_tokens", jmask)
    monkeypatch.setattr(masking, "mask_image_tokens", pmask)
    jsaved = _jax_saved(monkeypatch)
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jrecon, jpred = JV.visualize_predictions(jmodel, jvq, jvq_cfg, jprompting, imgs, ["x", ""],
                                             str(tmp_path / "j"), 3)
    written, write = _writer()
    recon, pred = V.visualize_predictions(model, vq, vq_cfg, prompting, imgs, ["x", ""],
                                          str(tmp_path / "p"), 3, write)
    np.testing.assert_allclose(recon, np.asarray(jrecon), **PIXEL_TOL)
    np.testing.assert_allclose(pred, np.asarray(jpred), **PIXEL_TOL)
    assert [n for n, _ in written] == [n for n, _ in jsaved]
    assert written[0][0] == "pred_000_original.png" and len(written) == 6


def test_understanding_and_chat_match_jax(pair, tmp_path):
    (jmodel, jvq, jvq_cfg, jprompting), (model, vq, vq_cfg, prompting) = pair
    imgs = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    questions = ["what is this?", "how many?"]
    want = JV.understanding_images(jmodel, jvq, jvq_cfg, jprompting, jprompting.text_tokenizer,
                                   imgs, questions, str(tmp_path / "j"), 1, max_new_tokens=8,
                                   steps=4)
    got = V.understanding_images(model, vq, vq_cfg, prompting, prompting.text_tokenizer, imgs,
                                 questions, str(tmp_path / "p"), 1, max_new_tokens=8, steps=4)
    assert got == want
    chat = ["hello", "name a color"]
    want = JV.generate_chat_text(jmodel, jprompting.text_tokenizer, chat, str(tmp_path / "j"), 1,
                                 gen_length=8, steps=4, block_length=8)
    got = V.generate_chat_text(model, prompting.text_tokenizer, chat, str(tmp_path / "p"), 1,
                               gen_length=8, steps=4, block_length=8)
    assert got == want
    assert _files(tmp_path / "p", 1) == _files(tmp_path / "j", 1) == ["chat.jsonl",
                                                                      "mmu_answers.jsonl"]
    for name in ("chat.jsonl", "mmu_answers.jsonl"):
        assert (tmp_path / "p/validation/step_1" / name).read_text() == (
            tmp_path / "j/validation/step_1" / name).read_text()
    with pytest.raises(ValueError):
        V.understanding_images(model, vq, vq_cfg, prompting, prompting.text_tokenizer, imgs,
                               ["one"], str(tmp_path / "p"), 1, max_new_tokens=8, steps=4)


def _cadence_run(tmp_path, *extra):
    cfg = train_torch.read_config([
        "config=configs/tiny_test.yaml", "device=cpu", "dataset.synthetic=true",
        "training.max_train_steps=2", "experiment.generate_every=2", "experiment.log_every=1",
        "experiment.save_every=0", "training.validation_max_new_tokens=8",
        "training.validation_steps=4", f"experiment.output_dir={tmp_path}/out",
        "dataset.params.validation_prompts_file=validation_prompts/imagenet_prompts.txt",
        *extra,
    ])
    trainer, loader = train_torch.setup(cfg)
    trainer.fit(loader)
    return trainer, tmp_path / "out" / "validation" / "step_2"


def test_trainer_cadence_runs_every_hook(tmp_path, monkeypatch):
    """train_torch's Trainer on the repo's fixtures (the validation prompts,
    `mmu_validation/`, `lm_chat_validation/questions.jsonl`): every hook's
    files at step 2, PNGs written by PIL."""
    from PIL import Image

    monkeypatch.chdir(train_torch.__file__.rsplit("/", 1)[0])
    trainer, step_dir = _cadence_run(tmp_path)
    assert trainer.hook_failures == []
    names = sorted(p.name for p in step_dir.iterdir())
    assert names == sorted(["chat.jsonl", "mmu_answers.jsonl", "t2i_prompts.jsonl"]
                           + [f"t2i_{i:03d}.png" for i in range(4)]
                           + [f"pred_{i:03d}_{k}.png" for i in range(2)
                              for k in ("model", "original", "recon")])
    assert Image.open(step_dir / "t2i_000.png").size == (16, 16)
    answers = [json.loads(ln) for ln in (step_dir / "mmu_answers.jsonl").read_text().splitlines()]
    assert len(answers) == 8


def test_failing_hook_is_logged_with_traceback(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(train_torch.__file__.rsplit("/", 1)[0])

    def broken(*args, **kwargs):
        raise RuntimeError("chat hook broke")

    monkeypatch.setattr(V, "generate_chat_text", broken)
    with caplog.at_level(logging.ERROR):   # only the chat hook and the triptychs run
        trainer, step_dir = _cadence_run(tmp_path, "dataset.params.validation_prompts_file=none",
                                         f"dataset.params.mmu_validation_dir={tmp_path}")
    assert trainer.hook_failures == ["generate_chat_text"] and trainer.global_step == 2
    record = next(r for r in caplog.records if "generate_chat_text" in r.getMessage())
    assert record.exc_info and "chat hook broke" in caplog.text and "Traceback" in caplog.text
    assert (step_dir / "pred_000_model.png").exists() and not (step_dir / "chat.jsonl").exists()
