"""The two design arguments of B7's bodies, against the JAX package on the CPU.

* Zero-filled widths (the wgmma body): q, k and v padded with zero columns
  to the next instance width (64, 128, 256 or 512), the scale kept at
  1/sqrt(real D), the result sliced back, equal JAX's function at the real D:
  the one-pass tier against `xla_attention` (JAX's function at widths its
  Pallas kernel does not take), the long tier against `flash_attention_online`
  in interpret mode, unbiased and masked (a mask that shuts some query rows
  out entirely), with and without RoPE at the real D. The padded
  computation runs in float64: against the same computation at the real
  width it agrees to 1e-12 (the zero columns add exact zeros), against
  JAX's fp32 within atol 2e-6 (JAX's own fp32 rounding, scores of about
  +-15 at D 192-240, reaches 1.52e-6 against float64 on these inputs); at
  the instance of 512 within atol 3e-6 (JAX's online kernel in fp32 reaches
  2.02e-6 against float64 at D 512 on these inputs, 1.45e-6 at D 320).
* The one-walk fp32 schedule (the ffma body): 64-key tiles, a running max,
  the sum and the outputs rescaled, the division last, keys past Lk at -inf,
  written as plain torch here, against JAX's one-pass fp32 function within
  the forward bar of test_torch_attention_widths.py (1e-5), on a row that a
  finite-min mask shuts out and with Lk not a multiple of 64.
* The tensor maps the wgmma body describes (64-column boxes at any width;
  at the instance of 512, q in boxes of 64 rows and k, v of 32).
  The body each (dtype, head_dim) takes is pinned by
  test_torch_attention_widths.py::test_kernel_for_routes_by_dtype_and_width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops import attention as jax_attention
from mmada_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mmada_tpu.ops.flash_attention import flash_attention_online
from mmada_tpu_torch.ops.flash_attention import NEG_F32, wide_instance, wide_maps
from mmada_tpu_torch.ops.tensor_maps import BOX_COLS, describe

ZERO_FILL_TOL = dict(atol=2e-6, rtol=0)
ZERO_FILL_TOL_512 = dict(atol=3e-6, rtol=0)   # JAX's fp32 sums over 272-512 columns
EXACT_TOL = dict(atol=1e-12, rtol=0)
ONE_WALK_TOL = dict(atol=1e-5, rtol=0)   # FWD_TOL["fp32"] of test_torch_attention_widths.py
TILE = 64                                 # keys of a tile of the ffma body


@pytest.fixture(autouse=True)
def one_thread():
    """The plain computations on one torch thread (the suite runs in several worker
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def instance_width(d: int) -> int:
    """The wgmma body's instance that a real width d runs through (the
    port's `wide_instance` must agree)."""
    width = 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512
    assert wide_instance(d) == width
    return width


def _inputs(b, h, kvh, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, lq, d)).astype(np.float32),
            rng.normal(size=(b, kvh, lk, d)).astype(np.float32),
            rng.normal(size=(b, kvh, lk, d)).astype(np.float32))


def _shut_mask(b, l, shut):
    """A padding mask of b frames whose first `shut` positions are pads: as
    keys they are masked for every row, and a pad's query row has no allowed
    key (every bias the finite fp32 min)."""
    keep = np.ones((b, l), bool)
    keep[:, :shut] = False
    allowed = keep[:, None, :, None] & keep[:, None, None, :]
    return np.where(allowed, 0.0, NEG_F32).astype(np.float32)


def _rope_np(x, sin, cos):
    d2 = x.shape[-1] // 2
    rot = np.concatenate([-x[..., d2:], x[..., :d2]], axis=-1)
    return (x * cos + rot * sin).astype(np.float32)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    return t.repeat_interleave(h // t.shape[1], dim=1)


def _padded_attention(q, k, v, bias, d, long, width):
    """The instance's arithmetic on operands zero-filled to `width`: the
    scores over every padded column with the real scale, the output's first
    d columns. In float64, so that what remains against JAX's fp32 is JAX's
    own rounding, not the sum of two fp32 orders."""
    q, k, v = q.double(), k.double(), v.double()
    bias = None if bias is None else bias.double()
    pad = lambda t: torch.nn.functional.pad(t, (0, width - d))  # noqa: E731
    qp, kp, vp = pad(q), _heads(pad(k), q.shape[1]), _heads(pad(v), q.shape[1])
    s = torch.matmul(qp, kp.transpose(-1, -2)) * (1.0 / d ** 0.5)
    if bias is not None:
        s = s + bias
    if long:
        m = s.amax(-1, keepdim=True).clamp_min(NEG_F32)
        p = torch.exp(s - m)
        out = torch.matmul(p, vp) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = torch.matmul(p / p.sum(-1, keepdim=True), vp)
    return out[..., :d]


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("d", [16, 48, 96, 192, 240, 320, 512])
def test_zero_filled_width_is_the_real_width_function(d, long, masked, rope):
    b, h, kvh, l = 1, 2, 1, 128
    q, k, v = _inputs(b, h, kvh, l, l, d, seed=d + 2 * long + 4 * masked)
    if rope:   # at the real width, before any padding
        sin, cos = (np.asarray(t, np.float32) for t in jax_llada.rope_sin_cos(l, d, 10000.0))
        q, k = _rope_np(q, sin, cos), _rope_np(k, sin, cos)
    bias = _shut_mask(b, l, 11) if masked else None
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    if long:
        want = flash_attention_online(jq, jk, jv, bias=jb, block_q=128, block_k=128,
                                      interpret=True)
    else:
        want = jax_attention.xla_attention(jq, jk, jv, bias=jb)
    args = (*(torch.from_numpy(t) for t in (q, k, v)),
            None if bias is None else torch.from_numpy(bias), d, long)
    got = _padded_attention(*args, instance_width(d))
    np.testing.assert_allclose(got.numpy(), _padded_attention(*args, d).numpy(), **EXACT_TOL)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(ZERO_FILL_TOL if d <= 256 else ZERO_FILL_TOL_512))


def _one_walk(q, k, v, bias):
    """The ffma body's fp32 schedule: one walk over 64-key tiles with a
    running max (from -inf), the earlier sum and outputs rescaled by
    exp(m - m'), the division by the row sum last; keys past Lk score -inf."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    k, v = _heads(k, h), _heads(v, h)
    m = torch.full((b, h, lq, 1), -float("inf"))
    l = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, lk, TILE):
        kt = torch.zeros((b, h, TILE, d))
        vt = torch.zeros((b, h, TILE, d))
        n = min(TILE, lk - k0)
        kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        s = torch.matmul(q, kt.transpose(-1, -2)) * (1.0 / d ** 0.5)
        if bias is not None:
            s[..., :n] = s[..., :n] + bias[..., k0:k0 + n]
        s[..., n:] = -float("inf")
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vt)
        m = m_new
    return acc / l


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 96, 128, 256])
def test_one_walk_fp32_schedule_is_the_one_pass_function(d, masked):
    b, h, kvh, lq, lk = 2, 2, 1, 72, 200   # 200 keys: a last tile of 8
    q, k, v = _inputs(b, h, kvh, lq, lk, d, seed=30 + d)
    q = q * 2.0
    bias = None
    if masked:   # query rows 0-10 of each frame shut out entirely; keys 0-10 masked
        keep_q = np.ones((b, lq), bool)
        keep_q[:, :11] = False
        keep_k = np.ones((b, lk), bool)
        keep_k[:, :11] = False
        bias = np.where(keep_q[:, None, :, None] & keep_k[:, None, None, :], 0.0,
                        NEG_F32).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want = jax_attention.xla_attention(jq, jk, jv,
                                       bias=None if bias is None else jnp.asarray(bias))
    got = _one_walk(*(torch.from_numpy(t) for t in (q, k, v)),
                    None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **ONE_WALK_TOL)
    if d % 128 == 0 and not masked:   # JAX's Pallas one-pass kernel computes it too
        pallas = jax_flash_attention(jq, jk, jv, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32), **ONE_WALK_TOL)


@pytest.mark.parametrize("d", [16, 48, 96, 192, 240, 256])
def test_wide_body_maps_keep_the_real_width_in_full_boxes(d):
    """The wgmma body's tensor maps: dims at the real width, boxes of 64
    columns (the 128-byte swizzle's width) even where d is narrower; the
    other kernels keep their boxes of min(d, 64)."""
    t = torch.zeros((2, 3, 40, d), dtype=torch.bfloat16)
    spec = describe(t, 64, BOX_COLS)
    assert spec.dims == (d, 40, 3, 2)
    assert spec.box == (BOX_COLS, 64, 1, 1)
    assert spec.strides == (2 * d, 2 * d * 40, 2 * d * 40 * 3)
    assert describe(t, 64).box == (min(d, BOX_COLS), 64, 1, 1)


@pytest.mark.parametrize("d", [48, 192, 272, 320, 496, 512])
def test_wide_body_maps_of_each_instance(d):
    """`wide_maps`, the maps B7's wgmma body launches with: q in boxes of
    128 rows, k and v of 64 and the output of 64 up to the instance of 256;
    at the instance of 512 (272-512), whose blocks hold 64 query rows and
    stream K and V in tiles of 32 keys, q in boxes of 64 rows and k and v of
    32; every box 64 columns wide, every dim at the real width."""
    q = torch.zeros((2, 4, 40, d), dtype=torch.bfloat16)
    k, v = (torch.zeros((2, 2, 72, d), dtype=torch.bfloat16) for _ in range(2))
    out = torch.zeros((2, 40, 4, d), dtype=torch.bfloat16).transpose(1, 2)
    q_rows, kv_rows = (64, 32) if d > 256 else (128, 64)
    maps = wide_maps(q, k, v, out)
    for spec, rows, (l, h) in zip(maps, (q_rows, kv_rows, kv_rows, 64),
                                  ((40, 4), (72, 2), (72, 2), (40, 4))):
        assert spec.dims == (d, l, h, 2)
        assert spec.box == (BOX_COLS, rows, 1, 1)
    assert maps[3].strides == (2 * d * 4, 2 * d, 2 * d * 4 * 40)   # (B, Lq, H, D) storage
