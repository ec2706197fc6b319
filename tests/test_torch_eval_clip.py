"""The port's CLIP (`mmada_tpu_torch/eval/clip.py`) and the CLIP score
(`eval/image_quality.py`) against `transformers.CLIPModel` and the JAX
package's `clip_jax` on the same weights (a tiny random CLIPModel, the
config of `tests/test_image_quality.py`), rtol 1e-4 / atol 1e-5: text
features under both pooling rules (the legacy argmax of the ids when
`eos_token_id == 2`, else the first eos) and with a padding mask, image
features, the scores, the weights carried across from JAX, and the scorer's
summary against JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mmada_tpu.eval import clip_jax  # noqa: E402
from mmada_tpu.eval import image_quality as jax_iq  # noqa: E402
from mmada_tpu_torch.checkpoints.from_jax import clip_from_jax  # noqa: E402
from mmada_tpu_torch.eval import clip  # noqa: E402
from mmada_tpu_torch.eval import image_quality  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
EOS = {"legacy": 2, "first_eos": 97}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_clip(eos_token_id=2, seed=7):
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    tc = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=2, max_position_embeddings=16, vocab_size=99,
                        eos_token_id=eos_token_id)
    vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2, image_size=28, patch_size=14)
    cfg = CLIPConfig.from_text_vision_configs(tc, vc, projection_dim=24)
    torch.manual_seed(seed)
    return CLIPModel(cfg).eval(), cfg


@pytest.fixture(scope="module")
def pairs():
    """Each pooling rule's tiny CLIP in both packages, made once."""
    out = {}
    for name, eos in EOS.items():
        model, hf_cfg = tiny_clip(eos)
        cfg = clip.CLIPConfig.from_hf(hf_cfg)
        jcfg = clip_jax.CLIPJaxConfig.from_hf(hf_cfg)
        state = model.state_dict()
        out[name] = dict(model=model, cfg=cfg, jcfg=jcfg,
                         params=clip.from_torch_state(state, cfg, device="cpu"),
                         jparams=clip_jax.from_torch_state(state, jcfg))
    return out


@pytest.fixture(params=sorted(EOS))
def text_pair(pairs, request):
    """Both pooling rules: the text tower's tests."""
    return pairs[request.param]


@pytest.fixture
def pair(pairs):
    """The legacy rule (CLIP's published configs): the rest, which the
    pooling rule does not reach."""
    return pairs["legacy"]


def _inputs(cfg, seed):
    """Rows that hold the eos mid-row (the pooled position), and the legacy
    rule's larger ids after it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 90, size=(3, 12))
    for row, pos in enumerate((5, 11, 8)):
        ids[row, pos] = cfg.eos_token_id
    pixels = rng.normal(size=(3, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    return ids.astype(np.int64), pixels


def test_config_from_hf_equals_jax(text_pair):
    assert dataclasses.asdict(text_pair["cfg"]) == dataclasses.asdict(text_pair["jcfg"])


def test_text_features_match_transformers_and_jax(text_pair):
    cfg = text_pair["cfg"]
    ids, _ = _inputs(cfg, 0)
    with torch.no_grad():
        want = text_pair["model"].get_text_features(input_ids=torch.tensor(ids)).numpy()
    got = clip.text_features(text_pair["params"], cfg, ids).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jgot = clip_jax.text_features(text_pair["jparams"], text_pair["jcfg"], jnp.asarray(ids))
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)


def test_text_features_with_padding_mask(text_pair):
    """Pads after each row's eos (mask 0): the causal mask and the pad mask
    summed, against transformers and JAX."""
    cfg = text_pair["cfg"]
    ids, _ = _inputs(cfg, 1)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0
    mask[2, 10:] = 0
    with torch.no_grad():
        want = text_pair["model"].get_text_features(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).numpy()
    got = clip.text_features(text_pair["params"], cfg, ids, mask).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jgot = clip_jax.text_features(text_pair["jparams"], text_pair["jcfg"], jnp.asarray(ids),
                                  jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)


def test_image_features_match_transformers_and_jax(pair):
    cfg = pair["cfg"]
    _, pixels = _inputs(cfg, 2)
    with torch.no_grad():
        want = pair["model"].get_image_features(pixel_values=torch.tensor(pixels)).numpy()
    got = clip.image_features(pair["params"], cfg, pixels).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jgot = clip_jax.image_features(pair["jparams"], pair["jcfg"], jnp.asarray(pixels))
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)


def test_clip_scores_match_jax_and_the_torchmetrics_formula(pair):
    cfg = pair["cfg"]
    ids, pixels = _inputs(cfg, 3)
    with torch.no_grad():
        img = pair["model"].get_image_features(pixel_values=torch.tensor(pixels))
        txt = pair["model"].get_text_features(input_ids=torch.tensor(ids))
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        want = (100.0 * (img * txt).sum(-1)).clamp(min=0).numpy()
    got = clip.clip_scores(pair["params"], cfg, pixels, ids).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jgot = clip_jax.clip_scores(pair["jparams"], pair["jcfg"], jnp.asarray(pixels),
                                jnp.asarray(ids))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-4, atol=1e-4)


def test_weights_from_jax_equal_the_torch_state(pair):
    """`clip_from_jax` of JAX's tree gives the converter's params bit for
    bit."""
    import jax

    got = clip_from_jax(jax.device_get(pair["jparams"]), device="cpu")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])

    want = dict(leaves(pair["params"]))
    have = dict(leaves(got))
    assert have.keys() == want.keys()
    for k, w in want.items():
        torch.testing.assert_close(have[k], w, rtol=0, atol=0, msg=k)


def test_scorer_summary_matches_jax(pair):
    """`ImageQualityScorer.quantitative_images` with the port's towers equals
    JAX's scorer with its towers on the same pixels and ids."""
    cfg = pair["cfg"]
    ids, pixels = _inputs(cfg, 4)
    hwc = np.transpose(pixels, (0, 2, 3, 1))
    port = image_quality.ImageQualityScorer(
        image_embed_fn=lambda px: clip.image_features(pair["params"], cfg,
                                                      np.transpose(px, (0, 3, 1, 2))),
        text_embed_fn=lambda texts: clip.text_features(pair["params"], cfg, ids[:len(texts)]))
    jax_scorer = jax_iq.ImageQualityScorer(
        image_embed_fn=lambda px: clip_jax.image_features(
            pair["jparams"], pair["jcfg"], jnp.asarray(np.transpose(px, (0, 3, 1, 2)))),
        text_embed_fn=lambda texts: clip_jax.text_features(
            pair["jparams"], pair["jcfg"], jnp.asarray(ids[:len(texts)])))
    got = port.quantitative_images(hwc, ["a", "b", "c"])
    want = jax_scorer.quantitative_images(hwc, ["a", "b", "c"])
    assert got.keys() == want.keys() == {"clip_score_mean", "clip_score"}
    np.testing.assert_allclose(got["clip_score"], want["clip_score"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["clip_score_mean"], want["clip_score_mean"], rtol=1e-4,
                               atol=1e-4)


def test_score_from_embeddings_equals_jax():
    rng = np.random.default_rng(5)
    img, txt = rng.normal(size=(2, 4, 8))
    np.testing.assert_array_equal(image_quality.clip_score_from_embeddings(img, txt),
                                  jax_iq.clip_score_from_embeddings(img, txt))


def test_load_scorer_refuses_a_directory_that_does_not_load(tmp_path):
    """No directory: generation only; a configured directory that does not
    load raises (JAX logs and drops the scorer)."""
    assert not image_quality.load_scorer(None, None, device="cpu").available
    with pytest.raises(Exception):
        image_quality.load_scorer(str(tmp_path / "missing"), device="cpu")
    with pytest.raises(Exception):
        image_quality.load_scorer(None, str(tmp_path / "missing.pt"), device="cpu")


def test_published_config_widths():
    """ViT-L/14 at its published widths: 257 vision tokens, about 428M
    weights (counted from the shapes `init_clip` draws)."""
    cfg = clip.clip_vit_l14()
    t, v = cfg.text, cfg.vision

    def tower(c):
        d, f = c.hidden_size, c.intermediate_size
        return c.num_layers * (4 * d * d + 4 * d + 4 * d + 2 * d * f + f + d)

    n = (tower(t) + tower(v) + cfg.vocab_size * t.hidden_size + cfg.max_positions * t.hidden_size
         + 2 * t.hidden_size + t.hidden_size * cfg.projection_dim
         + v.hidden_size + 3 * 14 * 14 * v.hidden_size + 257 * v.hidden_size
         + 4 * v.hidden_size + v.hidden_size * cfg.projection_dim)
    assert (cfg.image_size // cfg.patch_size) ** 2 + 1 == 257
    assert 427e6 < n < 429e6, n
