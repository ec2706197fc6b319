"""The port's ImageReward (`mmada_tpu_torch/eval/image_reward.py`) against
`transformers.BlipForImageTextRetrieval` and the JAX package's
`image_reward_jax` on the same weights (a tiny random BLIP, the config of
`tests/test_image_quality.py`), rtol 1e-4 / atol 1e-5: the BLIP vision
tower, the cross-modal text encoder (with and without a padding mask), the
rewards through a five-layer head, under both converters (transformers'
names and the ImageReward checkpoint's own), and the weights carried across
from JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mmada_tpu.eval import image_reward_jax as JIR  # noqa: E402
from mmada_tpu_torch.checkpoints.from_jax import image_reward_from_jax  # noqa: E402
from mmada_tpu_torch.eval import image_quality  # noqa: E402
from mmada_tpu_torch.eval import image_reward as IR  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_blip():
    from transformers import (BlipConfig, BlipForImageTextRetrieval, BlipTextConfig,
                              BlipVisionConfig)

    # 40 positions: the scorer pads its prompts to ImageReward's 35 tokens
    tc = BlipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=2, max_position_embeddings=40, vocab_size=99,
                        encoder_hidden_size=32)
    vc = BlipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2, image_size=28, patch_size=14)
    cfg = BlipConfig.from_text_vision_configs(tc, vc)
    torch.manual_seed(11)
    return BlipForImageTextRetrieval(cfg).eval(), cfg


def mlp_state(text_hidden, seed=6):
    """A five-layer head (ImageReward's widths / 16) in the checkpoint's
    `mlp.layers.{i}` names."""
    rng = np.random.default_rng(seed)
    dims = [text_hidden, 1024 // 16, 128 // 16, 64 // 16, 16 // 16]
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"mlp.layers.{i}.weight"] = torch.tensor(rng.normal(size=(b, a)).astype(np.float32))
        out[f"mlp.layers.{i}.bias"] = torch.tensor(rng.normal(size=(b,)).astype(np.float32))
    return out


def native_state(state, cfg, mlp):
    """The transformers state in ImageReward's own names (timm ViT keys)."""
    native = {"blip." + k: v for k, v in state.items() if k.startswith("text_encoder.")}
    tv = {"cls_token": state["vision_model.embeddings.class_embedding"],
          "pos_embed": state["vision_model.embeddings.position_embedding"],
          "patch_embed.proj.weight": state["vision_model.embeddings.patch_embedding.weight"],
          "patch_embed.proj.bias": state["vision_model.embeddings.patch_embedding.bias"],
          "norm.weight": state["vision_model.post_layernorm.weight"],
          "norm.bias": state["vision_model.post_layernorm.bias"]}
    timm_of = {"attn.qkv": "self_attn.qkv", "attn.proj": "self_attn.projection",
               "norm1": "layer_norm1", "norm2": "layer_norm2", "mlp.fc1": "mlp.fc1",
               "mlp.fc2": "mlp.fc2"}
    for i in range(cfg.vision_layers):
        for timm, hf in timm_of.items():
            for suf in ("weight", "bias"):
                tv[f"blocks.{i}.{timm}.{suf}"] = state[
                    f"vision_model.encoder.layers.{i}.{hf}.{suf}"]
    native.update({f"blip.visual_encoder.{k}": v for k, v in tv.items()})
    native.update(mlp)
    return native


@pytest.fixture(scope="module")
def blip():
    model, hf_cfg = tiny_blip()
    cfg = IR.BlipRewardConfig.from_hf(hf_cfg)
    jcfg = JIR.BlipRewardConfig.from_hf(hf_cfg)
    state = model.state_dict()
    mlp = mlp_state(cfg.text_hidden)
    native = native_state(state, cfg, mlp)
    return dict(model=model, cfg=cfg, jcfg=jcfg, native=native,
                params=IR.from_blip_torch_state(state, cfg, mlp_state=mlp, device="cpu"),
                native_params=IR.from_imagereward_state(native, cfg, device="cpu"),
                jparams=JIR.from_blip_torch_state(state, jcfg, mlp_state=mlp),
                jnative=JIR.from_imagereward_state(native, jcfg))


def _inputs(seed, n=2, length=10):
    rng = np.random.default_rng(seed)
    pixels = rng.normal(size=(n, 3, 28, 28)).astype(np.float32)
    ids = rng.integers(3, 90, size=(n, length)).astype(np.int64)
    mask = np.ones((n, length), np.int64)
    mask[1, 7:] = 0
    return pixels, ids, mask


@pytest.mark.parametrize("names", ["transformers", "imagereward"])
def test_vision_tower_matches_transformers_and_jax(blip, names):
    params = blip["params"] if names == "transformers" else blip["native_params"]
    jparams = blip["jparams"] if names == "transformers" else blip["jnative"]
    pixels, _, _ = _inputs(4)
    with torch.no_grad():
        want = blip["model"].vision_model(pixel_values=torch.tensor(pixels)).last_hidden_state
    got = IR.vision_forward(params, blip["cfg"], pixels).numpy()
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    jgot = JIR.vision_forward(jparams, blip["jcfg"], jnp.asarray(pixels))
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)


@pytest.mark.parametrize("names", ["transformers", "imagereward"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_modal_encoder_matches_transformers_and_jax(blip, names, masked):
    """The text encoder cross-attending to every vision token, the forward
    ImageReward pools its feature from."""
    params = blip["params"] if names == "transformers" else blip["native_params"]
    jparams = blip["jparams"] if names == "transformers" else blip["jnative"]
    pixels, ids, mask = _inputs(5)
    if not masked:
        mask = np.ones_like(mask)
    with torch.no_grad():
        img = blip["model"].vision_model(pixel_values=torch.tensor(pixels)).last_hidden_state
        want = blip["model"].text_encoder(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
            encoder_hidden_states=img,
            encoder_attention_mask=torch.ones(img.shape[:2], dtype=torch.long),
        ).last_hidden_state.numpy()
    img_p = IR.vision_forward(params, blip["cfg"], pixels)
    got = IR.text_forward(params, blip["cfg"], ids, img_p, mask).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    img_j = JIR.vision_forward(jparams, blip["jcfg"], jnp.asarray(pixels))
    jgot = JIR.text_forward(jparams, blip["jcfg"], jnp.asarray(ids), img_j, jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)


@pytest.mark.parametrize("names", ["transformers", "imagereward"])
def test_rewards_match_jax_and_the_torch_head(blip, names):
    """`rewards` through the five-layer head: JAX's, and transformers' [CLS]
    feature through the same linear stack, z-normalized."""
    params = blip["params"] if names == "transformers" else blip["native_params"]
    jparams = blip["jparams"] if names == "transformers" else blip["jnative"]
    pixels, ids, mask = _inputs(6)
    got = IR.rewards(params, blip["cfg"], pixels, ids, mask).numpy()
    assert got.shape == (2,) and np.isfinite(got).all()
    jgot = JIR.rewards(jparams, blip["jcfg"], jnp.asarray(pixels), jnp.asarray(ids),
                       jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-4, atol=1e-4)
    mlp = mlp_state(blip["cfg"].text_hidden)
    with torch.no_grad():
        img = blip["model"].vision_model(pixel_values=torch.tensor(pixels)).last_hidden_state
        h = blip["model"].text_encoder(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
            encoder_hidden_states=img,
            encoder_attention_mask=torch.ones(img.shape[:2], dtype=torch.long),
        ).last_hidden_state[:, 0]
        for i in range(4):
            h = h @ mlp[f"mlp.layers.{i}.weight"].T + mlp[f"mlp.layers.{i}.bias"]
    want = ((h[:, 0] - IR.REWARD_MEAN) / IR.REWARD_STD).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (IR.REWARD_MEAN, IR.REWARD_STD) == (JIR.REWARD_MEAN, JIR.REWARD_STD)


def test_weights_from_jax_give_the_same_rewards(blip):
    """`image_reward_from_jax` of JAX's tree: the converter's leaves bit for
    bit, the head's (w, b) in order."""
    got = image_reward_from_jax(jax.device_get(blip["jparams"]), device="cpu")
    want = blip["params"]
    for tower in ("text", "vision"):
        for k, w in want[tower].items():
            if isinstance(w, dict):
                for kk, ww in w.items():
                    torch.testing.assert_close(got[tower][k][kk], ww, rtol=0, atol=0)
            else:
                torch.testing.assert_close(got[tower][k], w, rtol=0, atol=0)
    assert len(got["mlp"]) == len(want["mlp"]) == 4
    for (gw, gb), (ww, wb) in zip(got["mlp"], want["mlp"]):
        torch.testing.assert_close(gw, ww, rtol=0, atol=0)
        torch.testing.assert_close(gb, wb, rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(28, 28), (44, 36)])
def test_reward_scorer_reads_an_imagereward_checkpoint(blip, tmp_path, monkeypatch, hw):
    """`reward_scorer` on a directory holding `ImageReward.pt` (the native
    names) and a BERT tokenizer: the pixels through `blip_pixels` (resized
    when they are not the config's size, as a generator's images are not)
    and the tokenizer's ids (max length 35), against `rewards` on the same
    inputs. The geometry is the tiny one (the loader fixes v1.0's)."""
    from transformers import BertTokenizer

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "red", "fox", "cat", "on",
             "snow"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(str(tmp_path))
    torch.save(blip["native"], tmp_path / "ImageReward.pt")
    monkeypatch.setattr(IR, "image_reward_v1", lambda: blip["cfg"])
    reward = image_quality.reward_scorer(str(tmp_path), device="cpu")
    rng = np.random.default_rng(8)
    hwc = rng.uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    prompts = ["a red fox", "a cat on snow"]
    got = reward(hwc, prompts).numpy()
    tok = BertTokenizer.from_pretrained(str(tmp_path))
    enc = tok(prompts, padding="max_length", truncation=True, max_length=35, return_tensors="np")
    pixels = image_quality.blip_pixels(hwc, blip["cfg"].image_size)
    assert pixels.shape == (2, 3, 28, 28)
    want = IR.rewards(blip["native_params"], blip["cfg"], pixels, enc["input_ids"],
                      enc["attention_mask"]).numpy()
    np.testing.assert_array_equal(got, want)
    scorer = image_quality.load_scorer(None, str(tmp_path), device="cpu")
    assert set(scorer.quantitative_images(hwc, prompts)) == {"image_reward_mean"}


@pytest.mark.parametrize("hw", [(28, 28), (40, 48), (48, 40), (512, 512)])
def test_blip_pixels_is_the_inference_transform(hw):
    """`blip_pixels` at 28 px (224 for 512) against the ImageReward repo's
    transform on the same images: PIL's bicubic resize of the shorter side
    (on float pixels, mode "F"), the center crop, CLIP's normalization;
    within 1e-4 after normalization, under a hundredth of a uint8 level."""
    from PIL import Image

    size = 224 if hw[0] == 512 else 28
    hwc = np.random.default_rng(9).uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    h, w = hw
    new = (int(size * w / h), size) if h <= w else (size, int(size * h / w))   # PIL: (W, H)
    top, left = int(round((new[1] - size) / 2.0)), int(round((new[0] - size) / 2.0))
    want = []
    for im in (hwc + 1.0) / 2.0:
        chans = [np.asarray(Image.fromarray(im[..., c], mode="F").resize(new, Image.BICUBIC))
                 for c in range(3)]
        x = np.clip(np.stack(chans), 0, 1)[:, top:top + size, left:left + size]
        want.append((x - image_quality.IMAGE_MEAN[:, None, None])
                    / image_quality.IMAGE_STD[:, None, None])
    got = image_quality.blip_pixels(hwc, size)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-4)
