"""The port's motion VQ-VAE against the goldens and the JAX package.

The bars of tests/test_motion_vq.py on `motion_vq.npz` (encoder and decoder
against the reference) and `motion_quantizers.npz` (two training steps of
each codebook variant, and the gradient quantizer); then, on weights carried
over from a JAX init by `motion_vq_from_jax`: encode's codes exact, decode
within 1e-5, each variant's `forward_train` (recon, commit loss, perplexity,
new codebook and state) within 1e-5 on a batch of at least `nb_code` vectors
(no tiling noise is drawn there), the losses, `ema_update` and the reference
state dict's import.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.checkpoints import motion_import as jax_motion_import
from mmada_tpu.models import motion_vq as J
from mmada_tpu_torch.checkpoints.from_jax import motion_vq_from_jax, motion_vq_state_from_jax
from mmada_tpu_torch.checkpoints.motion_import import motion_vq_from_torch
from mmada_tpu_torch.models import motion_vq as P

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _golden():
    data = np.load(os.path.join(GOLDENS, "motion_vq.npz"))
    enc = {k[4:]: data[k] for k in data.files if k.startswith("we::")}
    dec = {k[4:]: data[k] for k in data.files if k.startswith("wd::")}
    rest = {k: data[k] for k in data.files if "::" not in k}
    return enc, dec, rest


def test_encoder_and_decoder_match_golden():
    """The reference encoder's and decoder's state dicts load by their own
    keys; latents and reconstructions at the JAX test's bar."""
    enc, dec, rest = _golden()
    cfg = P.tiny_motion_cfg()
    vq = motion_vq_from_torch({**{f"vqvae.encoder.{k}": v for k, v in enc.items()},
                               **{f"vqvae.decoder.{k}": v for k, v in dec.items()}},
                              cfg, device="cpu")
    z = P.encoder_forward(vq, cfg, _t(rest["motion"]).transpose(1, 2))
    np.testing.assert_allclose(z.detach().numpy(), rest["latents"].transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-4)
    recon = P.decoder_forward(vq, cfg, _t(rest["latents"]).transpose(1, 2))
    np.testing.assert_allclose(recon.detach().numpy(), rest["recon"].transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-4)
    assert float(vq.codebook.detach().abs().sum()) == 0  # no codebook in the dict: zeros


def test_quantize_roundtrip_and_perplexity():
    cfg = P.tiny_motion_cfg()
    codebook = _t(np.random.default_rng(0).normal(size=(cfg.nb_code, cfg.code_dim)))
    codes = P.quantize(codebook, codebook)
    np.testing.assert_array_equal(codes.numpy(), np.arange(cfg.nb_code))
    assert torch.equal(P.dequantize(codebook, codes), codebook)
    some = torch.tensor([[0, 3, 3, 7], [7, 7, 1, 0]])
    np.testing.assert_allclose(float(P.perplexity_of(some, cfg.nb_code)),
                               float(J.perplexity_of(jnp.asarray(some.numpy()), cfg.nb_code)),
                               rtol=1e-6)


def _nct_to_flat(x):
    return _t(np.transpose(x, (0, 2, 1)).reshape(-1, x.shape[1]))


@pytest.mark.parametrize("variant", ["ema_reset", "ema", "reset"])
def test_quantizer_variant_matches_golden(variant):
    """Two training steps (seed + update, then the steady update) against
    the reference at the JAX test's bars (N * T >= nb_code: no noise)."""
    g = dict(np.load(os.path.join(GOLDENS, "motion_quantizers.npz")))
    nb_code, code_dim = g[f"{variant}::codebook1"].shape
    cfg = dataclasses.replace(P.tiny_motion_cfg(), nb_code=nb_code, code_dim=code_dim,
                              quantizer=variant)
    codebook = torch.zeros(nb_code, code_dim) if variant != "reset" else torch.ones(
        nb_code, code_dim)
    state = P.CodebookState.create(cfg, device="cpu")
    for step, xname in ((1, "x1"), (2, "x2")):
        x_flat = _nct_to_flat(g[xname])
        z_q, _, codebook, state, ppl = P.quantizer_forward(None, codebook, state, x_flat, cfg)
        commit = torch.mean((x_flat - z_q) ** 2)
        n, c, t = g[xname].shape
        np.testing.assert_allclose(z_q.numpy().reshape(n, t, c).transpose(0, 2, 1),
                                   g[f"{variant}::xd{step}"], **TOL)
        np.testing.assert_allclose(float(commit), g[f"{variant}::commit{step}"],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(float(ppl), g[f"{variant}::ppl{step}"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(codebook.numpy(), g[f"{variant}::codebook{step}"], **TOL)


def test_gradient_quantizer_matches_golden():
    g = dict(np.load(os.path.join(GOLDENS, "motion_quantizers.npz")))
    codebook = _t(g["gradient::embedding"]).requires_grad_()
    x_flat = _nct_to_flat(g["x1"]).requires_grad_()
    z_q, loss, ppl, codes = P.gradient_quantizer_losses(codebook, x_flat, beta=1.0)
    n, c, t = g["x1"].shape
    np.testing.assert_allclose(z_q.detach().numpy().reshape(n, t, c).transpose(0, 2, 1),
                               g["gradient::zq"], **TOL)
    np.testing.assert_allclose(float(loss.detach()), g["gradient::loss"], atol=1e-6)
    np.testing.assert_allclose(float(ppl), g["gradient::ppl"], atol=1e-4)
    # the codebook learns through the first term, the encoder through the second
    gc, gx = torch.autograd.grad(loss, (codebook, x_flat))
    jgc, jgx = jax.grad(lambda cb, x: J.gradient_quantizer_losses(cb, x, 1.0)[1], (0, 1))(
        jnp.asarray(g["gradient::embedding"]), jnp.asarray(x_flat.detach().numpy()))
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)


def _jax_pair(cfg, seed=0, seeded_codebook=True):
    """A JAX init (its codebook seeded from latents, as after training) and
    the port's copy."""
    params = J.init_motion_vq(jax.random.key(seed), cfg)
    if seeded_codebook:
        z = J.encoder_forward(params["encoder"], cfg, jnp.asarray(_motion(cfg, b=2, seed=9)))
        params = dict(params, codebook=z.reshape(-1, cfg.code_dim)[:cfg.nb_code])
    return params, motion_vq_from_jax(jax.device_get(params), cfg, device="cpu")


def _motion(cfg, b=4, t=64, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, cfg.pose_dim)).astype(np.float32)


@pytest.mark.parametrize("t", [32, 64])
def test_encode_and_decode_match_jax(t):
    """Codes exact, decoded features within 1e-5, on weights carried over by
    `motion_vq_from_jax` (4 frames a code: down_t 2)."""
    jcfg, cfg = J.tiny_motion_cfg(), P.tiny_motion_cfg()
    jparams, vq = _jax_pair(jcfg)
    m = _motion(cfg, t=t)
    jc = np.asarray(J.encode(jparams, jcfg, jnp.asarray(m)))
    codes = P.encode(vq, cfg, torch.from_numpy(m))
    assert codes.shape == (4, t // 4)
    np.testing.assert_array_equal(codes.numpy(), jc)
    assert len(np.unique(jc)) > 4
    np.testing.assert_allclose(P.decode(vq, cfg, codes).numpy(),
                               np.asarray(J.decode(jparams, jcfg, jnp.asarray(jc))), **TOL)


@pytest.mark.parametrize("variant", ["ema_reset", "ema", "reset", "gradient"])
def test_forward_train_matches_jax(variant):
    """Two `forward_train` steps (the first seeds an uninitialized codebook
    from the batch; 64 vectors for 32 codes, so no noise is drawn): recon,
    commit loss and perplexity, the new codebook and state within 1e-5; the
    motion losses and the gradients of the conv weights too."""
    jcfg = dataclasses.replace(J.tiny_motion_cfg(), quantizer=variant)
    cfg = dataclasses.replace(P.tiny_motion_cfg(), quantizer=variant)
    jparams, vq = _jax_pair(jcfg, seeded_codebook=False)
    jstate, state = J.CodebookState.create(jcfg), P.CodebookState.create(cfg, device="cpu")
    for i in range(2):
        m = _motion(cfg, seed=i)

        def jloss(p):
            out = J.forward_train(jax.random.key(i), p, jstate, jcfg, jnp.asarray(m))
            total, parts = J.motion_losses(out[0], jnp.asarray(m), out[1])
            return total, (out, parts)

        (jtotal, (jout, jparts)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
        out = P.forward_train(None, vq, state, cfg, torch.from_numpy(m))
        total, parts = P.motion_losses(out[0], torch.from_numpy(m), out[1])
        for got, want in zip(out[:4], jout[:4]):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        for k in ("code_sum", "code_count", "initialized"):
            np.testing.assert_allclose(getattr(out[4], k).numpy(),
                                       np.asarray(getattr(jout[4], k)), **TOL)
        np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
        for k in parts:
            np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]), **TOL)
        grads = torch.autograd.grad(total, list(vq.parameters()), allow_unused=True)
        want = motion_vq_state_from_jax(jax.device_get(jgrads))
        for (name, _), g in zip(vq.named_parameters(), grads):
            if name == "codebook" and variant != "gradient":
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        # the next step starts from the updated codebook and state
        jparams = dict(jparams, codebook=jout[3])
        jstate = jout[4]
        with torch.no_grad():
            vq.codebook.copy_(out[3])
        state = out[4]


def test_tiling_noise_and_ema_update_match_jax_without_noise():
    """A batch smaller than the codebook seeds by tiling with noise (drawn
    from the generator; JAX's stream differs, so only its scale is held);
    `ema_update` on a full batch equals JAX's."""
    cfg = P.tiny_motion_cfg()
    x = _t(np.random.default_rng(2).normal(size=(10, cfg.code_dim)))
    tiled = P._tile_to(torch.Generator().manual_seed(0), x, cfg.nb_code)
    assert tiled.shape == (cfg.nb_code, cfg.code_dim)
    noise = tiled - x.repeat(4, 1)[:cfg.nb_code]
    assert 0 < float(noise.std()) < 0.01
    x = _t(np.random.default_rng(3).normal(size=(40, cfg.code_dim)))
    state = P.CodebookState.create(cfg, device="cpu")
    codes = torch.zeros(40, dtype=torch.long)
    cb, st, ppl = P.ema_update(None, torch.zeros(cfg.nb_code, cfg.code_dim), state, x, codes, 0.9)
    jcb, jst, jppl = J.ema_update(jax.random.key(0), jnp.zeros((cfg.nb_code, cfg.code_dim)),
                                  J.CodebookState.create(cfg), jnp.asarray(x.numpy()),
                                  jnp.zeros(40, jnp.int32), 0.9)
    np.testing.assert_allclose(cb.numpy(), np.asarray(jcb), **TOL)
    np.testing.assert_allclose(st.code_count.numpy(), np.asarray(jst.code_count), **TOL)
    np.testing.assert_allclose(float(ppl), float(jppl), **TOL)


def test_reference_state_dict_imports_as_jax_does():
    """A `HumanVQVAE` state dict (prefixes, codebook) through the port's
    `motion_vq_from_torch` and through JAX's, then `motion_vq_from_jax`:
    the same weights."""
    cfg = P.tiny_motion_cfg()
    src = P.init_motion_vq(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    state = {f"vqvae.{k}" if k != "codebook" else "vqvae.quantizer.codebook": v.detach().numpy()
             for k, v in src.state_dict().items()}
    state["vqvae.quantizer.codebook"] = np.random.default_rng(0).normal(
        size=(cfg.nb_code, cfg.code_dim)).astype(np.float32)
    got = motion_vq_from_torch(state, cfg, device="cpu")
    via_jax = motion_vq_from_jax(jax.device_get(jax_motion_import.motion_vq_from_torch(
        state, J.tiny_motion_cfg())), cfg, device="cpu")
    for (k, a), (_, b) in zip(got.state_dict().items(), via_jax.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(RuntimeError, match="Missing key"):
        motion_vq_from_torch({k: v for k, v in state.items() if "decoder" not in k}, cfg,
                             device="cpu")
