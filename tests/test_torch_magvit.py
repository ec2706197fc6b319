"""The port's MAGVIT-v2 against the torch reference goldens and the JAX package.

* `magvit_tiny.npz` (tiny VQGAN, 16 px, z_channels 5: 8 x 8 = 64 codes over
  a book of 32) through `magvit2_params_from_torch`: the bars of
  `tests/test_magvit_parity.py` (latents atol 2e-4 / rtol 1e-3, codes and
  `z_entry` bit for bit, decode atol 5e-4 / rtol 1e-3, round trip stable).
* JAX `init_magvit2` params at `tiny_vqgan(16)` and `tiny_vqgan(32)` (its
  attention sits at level 1) through `magvit2_from_jax`: latents and pixels
  at those bars, codes equal, the LFQ functions exact, `lfq_losses` atol
  1e-6, `group_norm` atol 1e-5, `decode_images` bit for bit against
  `inference_t2i.py`'s arithmetic.
* The flagship's tree (`magvit2_default()`) has JAX's structure and shapes.

All in fp32 on the CPU (the FP32 bars of the JAX tests); weights stored in
bf16 compute in fp32 on fp32 pixels, in both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.checkpoints.magvit_import import (
    magvit2_params_from_torch as jax_magvit2_params_from_torch,
)
from mmada_tpu.models import magvit2 as jax_magvit2
from mmada_tpu.ops.norms import group_norm as jax_group_norm
from mmada_tpu_torch.checkpoints.from_jax import magvit2_from_jax
from mmada_tpu_torch.checkpoints.magvit_import import (
    magvit2_params_from_fused_state,
    magvit2_params_from_torch,
)
from mmada_tpu_torch.entry import decode_images
from mmada_tpu_torch.models import magvit2
from mmada_tpu_torch.ops.norms import group_norm

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
LATENT_TOL = dict(atol=2e-4, rtol=1e-3)
PIXEL_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(GOLDENS, "magvit_tiny.npz"))
    enc = {k[4:]: data[k] for k in data.files if k.startswith("we::")}
    dec = {k[4:]: data[k] for k in data.files if k.startswith("wd::")}
    rest = {k: data[k] for k in data.files if "::" not in k}
    cfg = magvit2.tiny_vqgan()
    return magvit2_params_from_torch(enc, dec, cfg, device="cpu"), cfg, rest, enc, dec


def nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def test_golden_latents(golden):
    params, cfg, rest, *_ = golden
    latents = magvit2.encoder_forward(params["encoder"], cfg, nhwc(rest["pixels"]))
    np.testing.assert_allclose(latents.numpy(), rest["latents"].transpose(0, 2, 3, 1),
                               **LATENT_TOL)


def test_golden_codes_bit_exact(golden):
    params, cfg, rest, *_ = golden
    codes = magvit2.get_code(params, cfg, nhwc(rest["pixels"]))
    np.testing.assert_array_equal(codes.numpy(), rest["codes"])
    zq, again = magvit2.encode(params, cfg, nhwc(rest["pixels"]))
    np.testing.assert_array_equal(again.numpy(), rest["codes"])
    assert set(np.unique(zq.numpy())) <= {-1.0, 1.0}


def test_golden_codebook_entry_bit_exact(golden):
    _, cfg, rest, *_ = golden
    z = magvit2.lfq_codebook_entry(torch.from_numpy(rest["codes"]), cfg.z_channels)
    np.testing.assert_array_equal(z.numpy(), rest["z_entry"].transpose(0, 2, 3, 1))


def test_golden_decode(golden):
    params, cfg, rest, *_ = golden
    recon = magvit2.decode_code(params, cfg, torch.from_numpy(rest["codes"]))
    np.testing.assert_allclose(recon.numpy(), rest["recon"].transpose(0, 2, 3, 1), **PIXEL_TOL)


def test_golden_roundtrip_codes_stable(golden):
    """Codebook entries are fixed points of the quantizer."""
    _, cfg, rest, *_ = golden
    codes = torch.from_numpy(rest["codes"])
    z = magvit2.lfq_codebook_entry(codes, cfg.z_channels)
    assert torch.equal(magvit2.lfq_indices(z, cfg.z_channels), codes)
    assert torch.equal(magvit2.lfq_quantize(z), z)


def test_fused_state_and_dtype(golden):
    """The fused state dict gives the split one's tree; bf16-stored weights
    hold bf16 values and compute in fp32 as JAX's do."""
    params, cfg, rest, enc, dec = golden
    fused = {**{f"encoder.{k}": v for k, v in enc.items()},
             **{f"decoder.{k}": v for k, v in dec.items()}, "quantize.power_vals": np.ones(5)}
    again = magvit2_params_from_fused_state(fused, cfg, device="cpu")
    flat = dict(_leaves(params))
    assert dict(_leaves(again)).keys() == flat.keys()
    assert all(torch.equal(t, flat[k]) for k, t in _leaves(again))
    half = magvit2_params_from_torch(enc, dec, cfg, dtype=torch.bfloat16, device="cpu")
    jhalf = jax_magvit2_params_from_torch(enc, dec, jax_magvit2.tiny_vqgan(), dtype=jnp.bfloat16)
    pixels = rest["pixels"].transpose(0, 2, 3, 1)
    want = jax_magvit2.encoder_forward(jhalf["encoder"], jax_magvit2.tiny_vqgan(),
                                       jnp.asarray(pixels))
    got = magvit2.encoder_forward(half["encoder"], cfg, torch.from_numpy(pixels.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LATENT_TOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")


@pytest.fixture(scope="module", params=[16, 32], ids=["res16", "res32"])
def jax_pair(request):
    """JAX params at tiny_vqgan(res), the same params in the port, and
    pixels of that resolution made from a seed."""
    res = request.param
    jcfg = jax_magvit2.tiny_vqgan(res)
    jparams = jax_magvit2.init_magvit2(jax.random.key(res), jcfg)
    cfg = magvit2.tiny_vqgan(res)
    params = magvit2_from_jax(jax.device_get(jparams), cfg, device="cpu")
    pixels = np.random.default_rng(res).uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    return jparams, jcfg, params, cfg, pixels


def test_encoder_matches_jax(jax_pair):
    jparams, jcfg, params, cfg, pixels = jax_pair
    want = np.asarray(jax_magvit2.encoder_forward(jparams["encoder"], jcfg, jnp.asarray(pixels)))
    got = magvit2.encoder_forward(params["encoder"], cfg, torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), want, **LATENT_TOL)
    codes = magvit2.get_code(params, cfg, torch.from_numpy(pixels))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jax_magvit2.get_code(jparams, jcfg, pixels)))
    jzq, jcodes = jax_magvit2.encode(jparams, jcfg, jnp.asarray(pixels))
    zq, codes = magvit2.encode(params, cfg, torch.from_numpy(pixels))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(jzq))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


def test_decoder_matches_jax(jax_pair):
    jparams, jcfg, params, cfg, _ = jax_pair
    n = (cfg.resolution // cfg.downsample_factor) ** 2
    codes = np.random.default_rng(1).integers(0, cfg.codebook_size, (2, n))
    want = np.asarray(jax_magvit2.decode_code(jparams, jcfg, jnp.asarray(codes, jnp.int32)))
    got = magvit2.decode_code(params, cfg, torch.from_numpy(codes))
    assert got.shape == (2, cfg.resolution, cfg.resolution, 3)
    np.testing.assert_allclose(got.numpy(), want, **PIXEL_TOL)
    z = np.random.default_rng(2).standard_normal(
        (2, cfg.resolution // 2, cfg.resolution // 2, cfg.z_channels)).astype(np.float32)
    np.testing.assert_allclose(
        magvit2.decoder_forward(params["decoder"], cfg, torch.from_numpy(z)).numpy(),
        np.asarray(jax_magvit2.decoder_forward(jparams["decoder"], jcfg, jnp.asarray(z))),
        **PIXEL_TOL)


def test_decode_images_matches_inference_t2i(jax_pair):
    """`(x + 1) * 127.5`, clipped and cast to uint8, bit for bit against the
    JAX package's decode through `inference_t2i.py`'s arithmetic; pixel
    values within the decode bar of JAX's can land on the other side of an
    integer, so the port's own decode is held bit for bit and JAX's within
    one level."""
    jparams, jcfg, params, cfg, _ = jax_pair
    n = (cfg.resolution // cfg.downsample_factor) ** 2
    codes = np.random.default_rng(3).integers(0, cfg.codebook_size, (3, n))
    images = decode_images(params, cfg, codes, device="cpu")
    assert images.dtype == torch.uint8 and images.shape == (3, cfg.resolution, cfg.resolution, 3)
    pixels = magvit2.decode_code(params, cfg, torch.from_numpy(codes)).numpy()
    want = np.asarray(jnp.clip((jnp.asarray(pixels) + 1.0) * 127.5, 0, 255)).astype(np.uint8)
    np.testing.assert_array_equal(images.numpy(), want)
    jpixels = jax_magvit2.decode_code(jparams, jcfg, jnp.asarray(codes, jnp.int32))
    jwant = np.asarray(jnp.clip((jpixels + 1.0) * 127.5, 0, 255)).astype(np.uint8)
    assert np.abs(images.numpy().astype(int) - jwant.astype(int)).max() <= 1


def test_convs_take_any_size_divisible_by_the_factor(jax_pair):
    """`cfg.resolution` only places the attention: 2x the resolution and a
    non-square image encode and decode as JAX's do."""
    jparams, jcfg, params, cfg, _ = jax_pair
    r = cfg.resolution
    for h, w in ((2 * r, 2 * r), (r, 2 * r)):
        pixels = np.random.default_rng(h + w).uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
        jz = jax_magvit2.encoder_forward(jparams["encoder"], jcfg, jnp.asarray(pixels))
        z = magvit2.encoder_forward(params["encoder"], cfg, torch.from_numpy(pixels))
        assert z.shape == (1, h // 2, w // 2, cfg.z_channels)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), **LATENT_TOL)
        codes = magvit2.lfq_indices(z, cfg.z_channels)
        shape = (h // 2, w // 2)
        np.testing.assert_allclose(
            magvit2.decode_code(params, cfg, codes, shape).numpy(),
            np.asarray(jax_magvit2.decode_code(jparams, jcfg, jnp.asarray(codes.numpy()), shape)),
            **PIXEL_TOL)


@pytest.mark.parametrize("z_channels", [5, 13])
def test_lfq_matches_jax_exactly(z_channels):
    """Signs with exact zeros (strictly positive is +1), the MSB in channel
    0, entries from codes, and the losses (atol 1e-6)."""
    rng = np.random.default_rng(z_channels)
    z = rng.standard_normal((2, 4, 4, z_channels)).astype(np.float32)
    z[0, 0, 0, :] = 0.0
    z[1, 2, 3, 0] = -0.0
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    np.testing.assert_array_equal(magvit2.lfq_quantize(zt).numpy(),
                                  np.asarray(jax_magvit2.lfq_quantize(zj)))
    codes = magvit2.lfq_indices(zt, z_channels)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jax_magvit2.lfq_indices(zj, z_channels)))
    assert int(codes[0, 0]) == 0
    one_hot = np.zeros((1, 1, 1, z_channels), np.float32)
    one_hot[..., 0] = 1.0
    assert int(magvit2.lfq_indices(torch.from_numpy(one_hot), z_channels)) == 2 ** (z_channels - 1)
    entry = magvit2.lfq_codebook_entry(codes, z_channels)
    np.testing.assert_array_equal(
        entry.numpy(), np.asarray(jax_magvit2.lfq_codebook_entry(jnp.asarray(codes.numpy()),
                                                                 z_channels)))
    for got, want in ((magvit2.lfq_losses(zt), jax_magvit2.lfq_losses(zj)),
                      (magvit2.lfq_losses(zt, beta=0.5), jax_magvit2.lfq_losses(zj, beta=0.5))):
        for k in ("entropy_loss", "commit_loss"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6)


@pytest.mark.parametrize("shape,groups,dtype", [
    ((2, 4, 4, 64), 32, np.float32),
    ((1, 3, 5, 96), 32, np.float32),
    ((2, 8, 8, 32), 8, np.float32),
    ((2, 8, 8, 32), 8, "bfloat16"),
], ids=["64ch", "odd-hw", "8-groups", "bf16"])
def test_group_norm_matches_jax(shape, groups, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    got = group_norm(xt, torch.from_numpy(w), torch.from_numpy(b), groups)
    want = jax_group_norm(xj, jnp.asarray(w), jnp.asarray(b), groups)
    assert got.dtype == xt.dtype
    # bf16 output: one bf16 ulp at |y| ~ 8 is 2^-4
    tol = 1e-5 if dtype != "bfloat16" else 2.0 ** -4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("make", [magvit2.magvit2_default, lambda: magvit2.tiny_vqgan(32)],
                         ids=["flagship", "tiny32"])
def test_init_tree_has_jax_structure(make):
    """Every leaf of JAX's init (traced, not computed) is in the port's
    init, at its OIHW shape, and nothing else is; attention blocks sit where
    `_level_plan` places them (none inside a level at the flagship, one a
    block at level 1 of tiny_vqgan(32))."""
    cfg = make()
    jshapes = jax.eval_shape(lambda k: jax_magvit2.init_magvit2(k, cfg), jax.random.key(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
        key = "".join(f"/{getattr(p, 'key', getattr(p, 'idx', None))}" for p in path)
        s = leaf.shape
        want[key] = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
    params = magvit2.init_magvit2(cfg, device="meta")
    got = {k: tuple(t.shape) for k, t in _leaves(params)}
    assert got == {k: tuple(v) for k, v in want.items()}
    levels_with_attn = [i for i, lvl in enumerate(params["encoder"]["down"]) if lvl["attn"]]
    assert levels_with_attn == ([] if cfg.resolution == 256 else [1])
    if cfg.resolution == 256:
        assert magvit2.param_count(params) == sum(np.prod(s) for s in want.values())
