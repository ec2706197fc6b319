"""The port's motion evaluation (`mmada_tpu_torch/eval/`) against the JAX
package and the reference goldens:

  * the T2M evaluators (BiGRU text / motion encoders, the movement conv
    encoder) against `tests/goldens/t2m_evaluator.npz` at
    `tests/test_t2m_eval.py`'s bars, and against JAX's wrapper on weights
    carried across;
  * the numpy modules (`t2m_metrics`, `motion_math`, `word_vectorizer`)
    against JAX's bit for bit and against `motion_math.npz`;
  * `evaluate_mmada_t2m` at greedy, temperature 0, on a tiny model with the
    motion vocab against JAX's on the same weights: codes token-exact,
    metrics within 1e-5; `evaluate_motion_vq` with MPJPE at 263 features /
    22 joints; the eval batches of a HumanML3D-layout tree against JAX's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.eval import components as jax_components
from mmada_tpu.eval import motion_math as jax_motion_math
from mmada_tpu.eval import t2m_eval as jax_t2m_eval
from mmada_tpu.eval import t2m_metrics as JM
from mmada_tpu.eval import word_vectorizer as jax_wv
from mmada_tpu.eval.t2m_evaluator import EvaluatorWrapper as JaxEvaluatorWrapper
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models import motion_vq as jax_motion_vq
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting import universal as jax_universal
from mmada_tpu_torch.checkpoints.from_jax import (evaluator_from_jax, motion_vq_from_jax,
                                                  params_from_jax)
from mmada_tpu_torch.core.config import Config
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.data.synthetic import write_humanml3d_tree
from mmada_tpu_torch.eval import components, motion_math, t2m_eval
from mmada_tpu_torch.eval import t2m_metrics as M
from mmada_tpu_torch.eval import word_vectorizer
from mmada_tpu_torch.eval.t2m_evaluator import (EvaluatorWrapper, motion_encoder_forward,
                                                movement_encoder_forward, text_encoder_forward)
from mmada_tpu_torch.models import llada, motion_vq
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    data = np.load(os.path.join(GOLDENS, "t2m_evaluator.npz"))
    split = {p: {k[4:]: data[k] for k in data.files if k.startswith(p + "::")}
             for p in ("wt", "wm", "wv")}
    rest = {k: data[k] for k in data.files if "::" not in k}
    return split["wt"], split["wm"], split["wv"], rest


# -------------------------------------------------------------- evaluators

def test_evaluators_match_the_golden():
    """Text, movement and motion encoders and the wrapper against the
    reference's torch evaluators."""
    wt, wm, wv, g = _golden()
    ev = EvaluatorWrapper.from_torch_checkpoint(wt, wm, wv, device="cpu")
    text = text_encoder_forward(ev.text_params, torch.tensor(g["word_embs"]),
                                torch.tensor(g["pos_onehot"]), torch.tensor(g["cap_lens"]))
    np.testing.assert_allclose(text.numpy(), g["text_emb"], **GOLDEN_TOL)
    move = movement_encoder_forward(ev.movement_params, torch.tensor(g["motions"][..., :-4]))
    np.testing.assert_allclose(move.numpy(), g["move_feats"], **GOLDEN_TOL)
    motion = motion_encoder_forward(ev.motion_params, move, torch.tensor(g["m_lens"] // 4))
    np.testing.assert_allclose(motion.numpy(), g["motion_emb"], **GOLDEN_TOL)
    text_emb, motion_emb = ev.get_co_embeddings(g["word_embs"], g["pos_onehot"], g["cap_lens"],
                                                g["motions"], g["m_lens"])
    np.testing.assert_allclose(motion_emb.numpy(), g["motion_emb"], **GOLDEN_TOL)
    np.testing.assert_allclose(text_emb.numpy(), g["text_emb"], **GOLDEN_TOL)


def test_evaluators_from_jax_match_jax():
    """The JAX wrapper's trees carried across (`evaluator_from_jax`) give
    JAX's embeddings; the synthetic evaluator equals JAX's draw for draw."""
    wt, wm, wv, g = _golden()
    jev = JaxEvaluatorWrapper.from_torch_checkpoint(wt, wm, wv)
    ev = evaluator_from_jax(*(jax.device_get(p) for p in (
        jev.text_params, jev.motion_params, jev.movement_params)), device="cpu")
    args = (g["word_embs"], g["pos_onehot"], g["cap_lens"], g["motions"], g["m_lens"])
    for got, want in zip(ev.get_co_embeddings(*args),
                         jev.get_co_embeddings(*(jnp.asarray(a) for a in args))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    cfg = motion_vq.tiny_motion_cfg()
    synth = components.synthetic_evaluator(cfg, device="cpu")
    jsynth = jax_components.synthetic_evaluator(jax_motion_vq.tiny_motion_cfg())
    carried = evaluator_from_jax(*(jax.device_get(p) for p in (
        jsynth.text_params, jsynth.motion_params, jsynth.movement_params)), device="cpu")
    for a, b in ((synth.text_params, carried.text_params),
                 (synth.motion_params, carried.motion_params),
                 (synth.movement_params, carried.movement_params)):
        for k in a:
            sub_a, sub_b = (a[k], b[k]) if isinstance(a[k], dict) else ({k: a[k]}, {k: b[k]})
            for kk in sub_a:
                torch.testing.assert_close(sub_a[kk], sub_b[kk], rtol=0, atol=0)
    assert synth.unit_length == jsynth.unit_length


def _random_evaluator():
    state = components.random_evaluator_state()
    return EvaluatorWrapper.from_torch_checkpoint(state["text_encoder"], state["motion_encoder"],
                                                  state["movement_encoder"], device="cpu")


def test_random_evaluator_has_the_published_widths():
    ev = _random_evaluator()
    assert tuple(ev.text_params["pos_emb_w"].shape) == (300, 15)
    assert tuple(ev.text_params["gru"]["w_hh_f"].shape) == (3 * 512, 512)
    assert tuple(ev.motion_params["gru"]["w_ih_b"].shape) == (3 * 1024, 1024)
    assert tuple(ev.movement_params["conv1"]["w"].shape) == (512, 259, 4)
    rng = np.random.default_rng(0)
    text, motion = ev.get_co_embeddings(
        rng.normal(size=(2, 8, 300)).astype(np.float32), np.eye(15, dtype=np.float32)[:8][None]
        .repeat(2, 0), np.array([8, 5]), rng.normal(size=(2, 40, 263)).astype(np.float32),
        np.array([40, 24]))
    assert text.shape == motion.shape == (2, 512)
    again = _random_evaluator()
    torch.testing.assert_close(again.motion_params["out"]["fc2_w"],
                               ev.motion_params["out"]["fc2_w"], rtol=0, atol=0)


# ----------------------------------------------------------- numpy modules

def test_metrics_equal_jax_bit_for_bit():
    _, _, _, g = _golden()
    top, match = M.calculate_R_precision(g["rp_e1"], g["rp_e2"], 3)
    jtop, jmatch = JM.calculate_R_precision(g["rp_e1"], g["rp_e2"], 3)
    np.testing.assert_array_equal(top, jtop)
    np.testing.assert_array_equal(top, g["rp_topk"])
    assert match == jmatch
    fid = M.calculate_frechet_distance(g["fid_mu1"], g["fid_s1"], g["fid_mu2"], g["fid_s2"])
    assert fid == JM.calculate_frechet_distance(g["fid_mu1"], g["fid_s1"], g["fid_mu2"],
                                                g["fid_s2"])
    np.testing.assert_allclose(fid, g["fid"], rtol=1e-8)
    rng = np.random.default_rng(2)
    text, gt = rng.normal(size=(2, 20, 8))
    gen = gt + rng.normal(size=(20, 8)) * 0.1
    assert M.evaluate_embeddings(text, gt, gen, diversity_times=10) == \
        JM.evaluate_embeddings(text, gt, gen, diversity_times=10)
    act = rng.normal(size=(5, 10, 8))
    assert M.calculate_multimodality(act, 4, np.random.default_rng(1)) == \
        JM.calculate_multimodality(act, 4, np.random.default_rng(1))
    mu, sigma = M.calculate_activation_statistics(gt)
    assert abs(M.calculate_frechet_distance(mu, sigma, mu, sigma)) < 1e-8


def test_motion_math_equals_jax_and_the_golden():
    data = np.load(os.path.join(GOLDENS, "motion_math.npz"))
    for fn in ("qrot", "qmul"):
        other = data["v"] if fn == "qrot" else data["r"]
        got = getattr(motion_math, fn)(data["q"], other)
        np.testing.assert_array_equal(got, getattr(jax_motion_math, fn)(data["q"], other))
        np.testing.assert_allclose(got, data[fn], atol=1e-5)
    joints = motion_math.recover_from_ric(data["ric_data"], 22)
    np.testing.assert_array_equal(joints, jax_motion_math.recover_from_ric(data["ric_data"], 22))
    np.testing.assert_allclose(joints, data["ric_joints"], atol=1e-4)
    np.testing.assert_array_equal(motion_math.qinv(data["q"]), jax_motion_math.qinv(data["q"]))


def test_word_vectorizers_equal_jax(tmp_path):
    import pickle

    words = ["unk", "walk", "left", "person"]
    np.save(tmp_path / "our_vab_data.npy", np.arange(12, dtype=np.float32).reshape(4, 3))
    with open(tmp_path / "our_vab_words.pkl", "wb") as f:
        pickle.dump(words, f)
    with open(tmp_path / "our_vab_idx.pkl", "wb") as f:
        pickle.dump({w: i for i, w in enumerate(words)}, f)
    ours = word_vectorizer.WordVectorizer(str(tmp_path), "our_vab")
    theirs = jax_wv.WordVectorizer(str(tmp_path), "our_vab")
    rand, jrand = word_vectorizer.RandomWordVectorizer(), jax_wv.RandomWordVectorizer()
    for token in ("walk/VERB", "left/ADV", "person/NOUN", "zebra/NOUN"):
        for a, b in ((ours, theirs), (rand, jrand)):
            for x, y in zip(a[token], b[token]):
                np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- the eval functions

def _special(vocab):
    t = vocab.text_vocab_size
    return dict(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
                som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=1, eos=2)


@pytest.fixture(scope="module")
def t2m_models():
    """A tiny model with the motion vocab (weights 8x the init: greedy codes
    that vary along the span), the tiny motion VQ-VAE and the synthetic
    evaluator, in both packages on the same weights."""
    jvocab = jax_tiny_layout(text_vocab_size=300).with_motion(32)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jmodel = JaxMMadaModel.init(jax.random.key(0), jcfg, jvocab)
    jmodel = dataclasses.replace(jmodel, params=jax.tree.map(lambda w: w * 8, jmodel.params))
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    vocab = tiny_layout(text_vocab_size=300).with_motion(32)
    model = MMadaModel(cfg=cfg, params=params_from_jax(jax.device_get(jmodel.params), cfg,
                                                       device="cpu"), vocab=vocab)
    jmv_cfg = jax_motion_vq.tiny_motion_cfg()
    jmv = jax_motion_vq.init_motion_vq(jax.random.key(1), jmv_cfg)
    jmv["codebook"] = jax.random.normal(jax.random.key(2), jmv["codebook"].shape)
    mv_cfg = motion_vq.MotionVQConfig(**dataclasses.asdict(jmv_cfg))
    mv = motion_vq_from_jax(jax.device_get(jmv), mv_cfg, device="cpu")
    sp = _special(vocab)
    prompting = UniversalPrompting(ByteTokenizer(), SpecialIds(**sp), max_text_len=8)
    jprompting = jax_universal.UniversalPrompting(jax_universal.ByteTokenizer(),
                                                  jax_universal.SpecialIds(**sp), max_text_len=8)
    return dict(model=model, jmodel=jmodel, mv=mv, mv_cfg=mv_cfg, jmv=jmv, jmv_cfg=jmv_cfg,
                prompting=prompting, jprompting=jprompting,
                ev=components.synthetic_evaluator(mv_cfg, device="cpu"),
                jev=jax_components.synthetic_evaluator(jmv_cfg))


def _items(pose_dim, n, seed, frames=16):
    rng = np.random.default_rng(seed)
    return [{"word_embs": rng.normal(size=(5, 12)).astype(np.float32),
             "pos_onehot": rng.normal(size=(5, 15)).astype(np.float32), "cap_len": 5,
             "caption": f"motion {seed} {i}",
             "motion": rng.normal(size=(frames, pose_dim)).astype(np.float32),
             "m_len": frames - 4 * (i % 2)} for i in range(n)]


class _Greedy:
    """A model with `t2m_generate` at greedy (neither eval passes `greedy`;
    at temperature 0 without it JAX still draws a categorical), recording
    the codes."""

    def __init__(self, model):
        self.model, self.vocab, self.codes = model, model.vocab, []

    @property
    def device(self):
        return self.model.device

    def t2m_generate(self, *args, **kwargs):
        out = self.model.t2m_generate(*args, greedy=True, **kwargs)
        self.codes.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
        return out


def test_evaluate_mmada_t2m_matches_jax_at_greedy(t2m_models):
    """Two batches through the sampler at T = 0, the VQ decode and the
    evaluators: the codes token-exact, every metric within 1e-5."""
    m = t2m_models
    batches = [t2m_eval.collate_eval_items(_items(m["mv_cfg"].pose_dim, 4, s)) for s in (0, 1)]
    cfg = t2m_eval.T2MEvalConfig(num_motion_tokens=4, timesteps=3, temperature=0.0,
                                 diversity_times=4)
    emb: dict = {}
    got = t2m_eval.evaluate_mmada_t2m(_Greedy(m["model"]), m["mv"], m["mv_cfg"], m["ev"],
                                      m["prompting"], batches, cfg, embeddings=emb)
    jmodel = _Greedy(m["jmodel"])
    want = jax_t2m_eval.evaluate_mmada_t2m(
        jmodel, m["jmv"], m["jmv_cfg"], m["jev"], m["jprompting"], batches,
        jax_t2m_eval.T2MEvalConfig(num_motion_tokens=4, timesteps=3, temperature=0.0,
                                   diversity_times=4))
    codes = np.clip(np.concatenate(jmodel.codes), 0, 31)
    np.testing.assert_array_equal(emb["codes"], codes)
    assert len(np.unique(codes)) > 1
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert 0 <= got["r_precision_top1"] <= 1 and got["diversity_gt"] > 0


def test_evaluate_mmada_t2m_draws_from_its_generator(t2m_models):
    """Sampling (temperature 1) from an explicit generator: the same seed
    gives the same metrics."""
    m = t2m_models
    batches = [t2m_eval.collate_eval_items(_items(m["mv_cfg"].pose_dim, 4, 2))]
    cfg = t2m_eval.T2MEvalConfig(num_motion_tokens=4, timesteps=3, diversity_times=3)
    runs = [t2m_eval.evaluate_mmada_t2m(m["model"], m["mv"], m["mv_cfg"], m["ev"],
                                        m["prompting"], batches, cfg,
                                        generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_evaluate_motion_vq_with_mpjpe_matches_jax():
    """The reconstruction eval at HumanML3D's 263 features (MPJPE over 22
    recovered joints), a small VQ-VAE, against JAX's on the same weights;
    without joints MPJPE is left out."""
    jcfg = dataclasses.replace(jax_motion_vq.tiny_motion_cfg(), pose_dim=263)
    jvq = jax_motion_vq.init_motion_vq(jax.random.key(3), jcfg)
    jvq["codebook"] = jax.random.normal(jax.random.key(4), jvq["codebook"].shape)
    cfg = motion_vq.MotionVQConfig(**dataclasses.asdict(jcfg))
    vq = motion_vq_from_jax(jax.device_get(jvq), cfg, device="cpu")
    ev = components.synthetic_evaluator(cfg, device="cpu")
    jev = jax_components.synthetic_evaluator(jcfg)
    batches = [t2m_eval.collate_eval_items(_items(263, 4, s, frames=24)) for s in (3, 4)]
    emb: dict = {}
    got = t2m_eval.evaluate_motion_vq(vq, cfg, ev, batches, diversity_times=4, embeddings=emb)
    want = jax_t2m_eval.evaluate_motion_vq(jvq, jcfg, jev, batches, diversity_times=4)
    assert got.keys() == want.keys() and "mpjpe" in got
    assert np.isfinite(got["mpjpe"]) and got["mpjpe"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert emb["rec"].shape == (8, ev.motion_params["out"]["fc2_w"].shape[0])
    none = t2m_eval.evaluate_motion_vq(vq, cfg, ev, batches, joints_num=None, diversity_times=4)
    assert "mpjpe" not in none and none["fid"] == got["fid"]


def test_eval_batches_of_a_humanml3d_tree_equal_jax(tmp_path):
    """`build_eval_batches` over the written tree (stand-in vectorizer)
    gives JAX's batches, and `build_word_vectorizer` / `build_evaluator`
    read the same keys (None without an evaluator directory)."""
    from mmada_tpu.core.config import Config as JaxConfig

    split = write_humanml3d_tree(str(tmp_path / "hml"), n_clips=6, pose_dim=263)
    raw = {"dataset": {"motion_root": str(tmp_path / "hml"), "split_file": split},
           "eval": {"batch_size": 4}}
    cfg, jcfg = Config(raw), JaxConfig(raw)
    wv, jwv = components.build_word_vectorizer(cfg), jax_components.build_word_vectorizer(jcfg)
    got = list(components.build_eval_batches(cfg, wv))
    want = list(jax_components.build_eval_batches(jcfg, jwv))
    assert [len(b["captions"]) for b in got] == [4]   # `batched` drops a partial batch
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["captions"] == w["captions"]
        for k in ("word_embs", "pos_onehot", "cap_lens", "motion", "m_lens"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert components.build_evaluator(cfg) is None
    assert components.build_eval_batches(Config({}), wv) is None


def test_build_evaluator_reads_the_published_checkpoint_layout(tmp_path):
    """`build_evaluator` on a directory holding `finest.tar` with the three
    state dicts (the golden's weights) gives the golden's embeddings."""
    wt, wm, wv, g = _golden()
    torch.save({"text_encoder": {k: torch.tensor(v) for k, v in wt.items()},
                "motion_encoder": {k: torch.tensor(v) for k, v in wm.items()},
                "movement_encoder": {k: torch.tensor(v) for k, v in wv.items()}},
               tmp_path / "finest.tar")
    ev = components.build_evaluator(Config({"eval": {"evaluator_dir": str(tmp_path)}}),
                                    device="cpu")
    _, motion = ev.get_co_embeddings(g["word_embs"], g["pos_onehot"], g["cap_lens"],
                                     g["motions"], g["m_lens"])
    np.testing.assert_allclose(motion.numpy(), g["motion_emb"], **GOLDEN_TOL)


def test_eval_t2m_cli_on_a_humanml3d_tree(tmp_path, capsys, monkeypatch):
    """`eval_t2m_torch.main` on the tiny config with the motion vocab, a
    tiny motion VQ-VAE, evaluators written as `finest.tar` and a written
    HumanML3D-layout tree: the printed metrics are `run`'s on `load`'s
    pieces; it returns 1 without the split or the evaluators, as
    `eval_t2m.py` does."""
    import json

    import eval_t2m_torch

    split = write_humanml3d_tree(str(tmp_path / "hml"), n_clips=8, pose_dim=8)
    (tmp_path / "ev").mkdir()
    torch.save(components.random_evaluator_state(
        pose_dim=8, text_hidden=8, text_out=6, move_hidden=8, move_out=6, motion_hidden=8,
        motion_out=6), tmp_path / "ev" / "finest.tar")
    data = [f"dataset.motion_root={tmp_path / 'hml'}", f"dataset.split_file={split}"]
    vq = [f"model.motion_vq_model.{k}={v}" for k, v in dataclasses.asdict(
        motion_vq.tiny_motion_cfg()).items() if k in ("pose_dim", "code_dim", "nb_code", "width",
                                                      "down_t", "depth", "dilation_growth_rate")]
    argv = ["config=configs/tiny_test.yaml", "device=cpu", "model.mmada.motion_vocab_size=32",
            "eval.batch_size=4", "eval.num_motion_tokens=4", "eval.timesteps=2", *vq, *data]
    monkeypatch.chdir(os.path.dirname(os.path.dirname(GOLDENS)))   # the repo: the config
    assert eval_t2m_torch.main(argv + [f"eval.evaluator_dir={tmp_path / 'ev'}"]) == 0
    printed = json.loads(capsys.readouterr().out)
    cfg = eval_t2m_torch.read_config(argv + [f"eval.evaluator_dir={tmp_path / 'ev'}"])
    loaded = eval_t2m_torch.load(cfg)
    assert loaded.model.vocab.motion_codebook_size == 32
    emb: dict = {}
    want = eval_t2m_torch.run(cfg, loaded, embeddings=emb)
    assert printed == {k: float(v) for k, v in want.items()}
    assert emb["gen"].shape == (8, 6) and 0 <= printed["r_precision_top1"] <= 1
    assert eval_t2m_torch.main(argv) == 1
    assert eval_t2m_torch.main(argv[:-2] + [f"eval.evaluator_dir={tmp_path / 'ev'}"]) == 1
