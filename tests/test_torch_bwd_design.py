"""The design arguments of B8's bodies (the attention backward), against the
JAX package on the CPU.

* Zero-filled widths (the wgmma body): q, k, v and dO padded with zero
  columns to the instance (64, 128 or 256), the scale kept at 1/sqrt(real
  D), the gradients sliced back, equal JAX's gradients at the real D (16,
  48, 96, 192, 240), both tiers' formulas, unbiased and with a mask that
  shuts query rows out (their cotangent zero, as the model gives them). None
  of these widths is one JAX's Pallas backward takes (head_dim % 128, ops/
  attention.py's rule), so the reference is `jax.vjp` of JAX's own function
  there, `xla_attention`. The padded computation runs in float64: against
  the same computation at the real width it agrees to 1e-12 (the zero
  columns add exact zeros), against JAX's fp32 within 2e-5 of the
  gradient's largest entry (JAX's own fp32 rounding reaches 1.5e-6 of it on
  these inputs).
* The wgmma body's rounding at wide heads, written as plain torch in fp32:
  the one-pass tier rounds p and ds to bf16 once before they enter the
  tensor cores, the long tier enters each fp32 left operand as hi + lo (two
  bf16 values). On bf16 inputs at D 192 and 256 it stays within phase 3's
  bars of JAX's fp32 gradients (chip_smoke.py: GRAD_REL_L2 / GRAD_MAX_REL,
  LONG_GRAD_REL_L2 / LONG_GRAD_MAX_REL), compared before the final cast to
  bf16, which the plain version shares (measured: the one-pass tier 1.8e-3
  rel L2 and 2.6e-3 of the largest entry, the long tier under 1e-5).
* The ffma body's long-tier dq schedule, written as plain torch: one walk
  over 64-key tiles, a running max from the finite min, the sum and the
  accumulator rescaled by exp(m - m'), the division by max(l, 1e-30) last;
  against JAX's fp32 dq within 1e-5 of its largest entry, with Lk not a
  multiple of 64 and rows a mask shuts out. (Its one-pass dq walks K twice,
  as the plain version's order wants, so it needs no such argument.)
* The instance of 256's splits, in float64: dkv's two warpgroups split the
  queries of a step's scores and the 256 output columns of dk and dv, and
  exchange p^T and ds^T; dq sums over stages of 32 keys. Each equals the
  whole computation.

The body each (dtype, head_dim) takes, forward and backward, is pinned by
test_torch_attention_widths.py::test_kernel_for_routes_by_dtype_and_width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.ops import attention as jax_attention
from mmada_tpu_torch.ops.flash_attention import NEG_F32

EXACT_TOL = dict(atol=1e-12, rtol=0)
ZERO_FILL_REL = 2e-5      # of each gradient's largest entry: JAX's fp32 rounding
ONE_WALK_REL = 1e-5       # GENERIC_GRAD_REL of chip_smoke.py
GRAD_REL_L2, GRAD_MAX_REL = 1e-2, 2e-2               # chip_smoke.py phase 3, one-pass
LONG_GRAD_REL_L2, LONG_GRAD_MAX_REL = 1e-3, 2.0 ** -7  # chip_smoke.py phase 3, long tier
TILE = 64                 # keys of a tile of the ffma body


@pytest.fixture(autouse=True)
def one_thread():
    """The plain computations on one torch thread (the suite runs in several worker
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def instance_width(d: int) -> int:
    """The wgmma body's instance that a real width d runs through."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def _inputs(b, h, kvh, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, lq, d)).astype(np.float32) * 2.0,
            rng.normal(size=(b, kvh, lk, d)).astype(np.float32),
            rng.normal(size=(b, kvh, lk, d)).astype(np.float32),
            rng.normal(size=(b, h, lq, d)).astype(np.float32))


def _shut_mask(b, lq, lk, shut):
    """A padding mask whose first `shut` positions are pads: masked as keys
    for every row, and a pad's query row has no allowed key (every bias the
    finite fp32 min); returns (bias, live query rows)."""
    keep_q = np.ones((b, lq), bool)
    keep_q[:, :shut] = False
    keep_k = np.ones((b, lk), bool)
    keep_k[:, :shut] = False
    bias = np.where(keep_q[:, None, :, None] & keep_k[:, None, None, :], 0.0, NEG_F32)
    return bias.astype(np.float32), keep_q[:, None, :, None].astype(np.float32)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    return t.repeat_interleave(h // t.shape[1], dim=1)


def _group_sum(t: torch.Tensor, kvh: int) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.view(b, kvh, h // kvh, l, d).sum(2)


def _jax_grads(q, k, v, dout, bias):
    """(dq, dk, dv) of JAX's function at the real width, fp32."""
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda a, b_, c: jax_attention.xla_attention(a, b_, c, bias=jb),
                     *(jnp.asarray(t) for t in (q, k, v)))
    return [np.array(g, np.float32) for g in vjp(jnp.asarray(dout))]


def _padded_grads(q, k, v, dout, bias, d, long, width):
    """The instance's backward on operands zero-filled to `width`, the scale
    1/sqrt(d), the gradients' first d columns, in float64: the one-pass
    tier's p normalised, the long tier's unnormalised with the division
    last and dkv's p = exp(s - lse)."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    h, kvh = q.shape[1], k.shape[1]
    pad = lambda t: torch.nn.functional.pad(t, (0, width - d))  # noqa: E731
    qp, dop = pad(q), pad(dout)
    kp, vp = _heads(pad(k), h), _heads(pad(v), h)
    scale = 1.0 / d ** 0.5
    s = torch.matmul(qp, kp.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.double()
    m = s.amax(-1, keepdim=True)
    if long:
        m = m.clamp_min(NEG_F32)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    if long:
        l = l.clamp_min(1e-30)
    out = torch.matmul(e / l, vp)
    delta = (dop * out).sum(-1, keepdim=True)
    dp = torch.matmul(dop, vp.transpose(-1, -2))
    if long:   # B5-dq: t = p (dp - delta) unnormalised, dq divided by l last
        dq = torch.matmul(e * (dp - delta), kp) / l * scale
    else:      # B3-dq: p normalised
        dq = torch.matmul(e / l * (dp - delta), kp) * scale
    p = torch.exp(s - (m + torch.log(l)))   # dkv: p = exp(s - lse)
    ds = p * (dp - delta)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), qp) * scale, kvh)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), dop), kvh)
    return [g[..., :d] for g in (dq, dk, dv)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("d", [16, 48, 96, 192, 240])
def test_zero_filled_width_gives_the_real_width_gradients(d, long, masked):
    b, h, kvh, l = 1, 2, 1, 128
    q, k, v, dout = _inputs(b, h, kvh, l, l, d, seed=d + 2 * long + 4 * masked)
    bias = None
    if masked:   # the shut rows' cotangent is zero, as the model gives them
        bias, live = _shut_mask(b, l, l, 11)
        dout = dout * live
    want = _jax_grads(q, k, v, dout, bias)
    args = (*(torch.from_numpy(t) for t in (q, k, v, dout)),
            None if bias is None else torch.from_numpy(bias), d, long)
    got = _padded_grads(*args, instance_width(d))
    real = _padded_grads(*args, d)
    for name, g, r, w in zip(("dq", "dk", "dv"), got, real, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **EXACT_TOL, err_msg=name)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ZERO_FILL_REL * np.abs(w).max(),
                                   err_msg=name)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _hi_lo(x: torch.Tensor) -> torch.Tensor:
    """x as it enters the tensor cores in the long tier: its bf16 rounding
    plus the bf16 rounding of the rest."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _wgmma_body_grads(q, k, v, dout, long):
    """The wgmma body's arithmetic in fp32 on bf16 operands: q.k^T and dO.v^T
    exact products summed in fp32; p and ds (dq's t, dkv's p^T and ds^T)
    rounded once to bf16 (one-pass) or entered as hi + lo (long) before
    ds.k, p^T.dO and ds^T.q; the gradients before their cast to bf16. delta
    from the fp32 output, as JAX's gradients take it, so that what remains
    is the body's rounding."""
    h, kvh, d = q.shape[1], k.shape[1], q.shape[3]
    enter = _hi_lo if long else (lambda x: x.bfloat16().float())
    kf, vf = _heads(k, h), _heads(v, h)
    scale = 1.0 / d ** 0.5
    s = torch.matmul(q, kf.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    delta = (dout * torch.matmul(e / l, vf)).sum(-1, keepdim=True)   # JAX's, from fp32
    dp = torch.matmul(dout, vf.transpose(-1, -2))
    if long:
        dq = torch.matmul(enter(e * (dp - delta)), kf) / l * scale
    else:
        dq = torch.matmul(enter(e / l * (dp - delta)), kf) * scale
    p = torch.exp(s - (m + torch.log(l)))
    dk = _group_sum(torch.matmul(enter(p * (dp - delta)).transpose(-1, -2), q) * scale, kvh)
    dv = _group_sum(torch.matmul(enter(p).transpose(-1, -2), dout), kvh)
    return dq, dk, dv


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("d", [192, 256])
def test_wgmma_body_rounding_at_wide_heads_meets_phase_3_bars(d, long):
    b, h, kvh, l = 1, 4, 2, 256
    q, k, v, dout = (_bf16(t) for t in _inputs(b, h, kvh, l, l, d, seed=60 + d + long))
    want = _jax_grads(q, k, v, dout, None)
    got = _wgmma_body_grads(*(torch.from_numpy(t) for t in (q, k, v, dout)), long)
    rel_l2, max_rel = (LONG_GRAD_REL_L2, LONG_GRAD_MAX_REL) if long else (GRAD_REL_L2,
                                                                          GRAD_MAX_REL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(w)
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) <= rel_l2, name
        assert float((g - w).abs().max()) <= max_rel * float(w.abs().max()), name


def _online_dq(q, k, v, dout, bias):
    """The ffma body's long-tier dq in fp32: one walk over 64-key tiles, the
    running max from the finite min, l and the accumulator rescaled by
    exp(m - m'), ds = p (dp - delta) unnormalised, the division by max(l,
    1e-30) last; keys past Lk score -inf. delta from the plain fp32 output,
    as the wrapper computes it."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    k, v = _heads(k, h), _heads(v, h)
    scale = 1.0 / d ** 0.5
    s_all = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s_all = s_all + bias
    p_all = torch.softmax(s_all, dim=-1)
    delta = (dout * torch.matmul(p_all, v)).sum(-1, keepdim=True)
    m = torch.full((b, h, lq, 1), NEG_F32)
    l = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, lk, TILE):
        n = min(TILE, lk - k0)
        s = torch.full((b, h, lq, TILE), -float("inf"))
        s[..., :n] = s_all[..., k0:k0 + n]
        dp = torch.zeros((b, h, lq, TILE))
        dp[..., :n] = torch.matmul(dout, v[:, :, k0:k0 + n].transpose(-1, -2))
        kt = torch.zeros((b, h, TILE, d))
        kt[:, :, :n] = k[:, :, k0:k0 + n]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p * (dp - delta), kt)
        m = m_new
    return acc / l.clamp_min(1e-30) * scale


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 128, 256])
def test_ffma_long_dq_schedule_is_the_function(d, masked):
    b, h, kvh, lq, lk = 2, 2, 1, 72, 200   # 200 keys: a last tile of 8
    q, k, v, dout = _inputs(b, h, kvh, lq, lk, d, seed=90 + d)
    bias = None
    if masked:   # rows 0-10 of each frame shut out entirely (cotangent zero); keys 0-10 masked
        bias, live = _shut_mask(b, lq, lk, 11)
        dout = dout * live
    want = _jax_grads(q, k, v, dout, bias)[0]
    got = _online_dq(*(torch.from_numpy(t) for t in (q, k, v, dout)),
                     None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ONE_WALK_REL * np.abs(want).max())


def test_wide_instance_splits_equal_the_whole():
    """dkv: each warpgroup's s^T and dp^T over its half of a step's 64
    queries, p^T and ds^T exchanged, dk and dv by halves of the 256 output
    columns; dq: ds . k summed over stages of 32 keys. In float64 against
    the whole computation."""
    b, h, kvh, l, d = 1, 2, 1, 128, 256
    q, k, v, dout = (torch.from_numpy(t).double() for t in _inputs(b, h, kvh, l, l, d, seed=7))
    kf, vf = _heads(k, h), _heads(v, h)
    scale = 1.0 / d ** 0.5
    s = torch.matmul(q, kf.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    delta = (dout * torch.matmul(p, vf)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dout, vf.transpose(-1, -2)) - delta)
    whole = (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), q),
             torch.matmul(p.transpose(-1, -2), dout))

    dk = torch.zeros(b, h, l, d, dtype=torch.float64)
    dv = torch.zeros(b, h, l, d, dtype=torch.float64)
    for k0 in range(0, l, 64):            # a block's 64 keys
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        for q0 in range(0, l, 64):        # a step's 64 queries
            halves = []
            for cw in range(2):           # each warpgroup's 32 queries
                qs = slice(q0 + 32 * cw, q0 + 32 * cw + 32)
                st = torch.matmul(kt, q[:, :, qs].transpose(-1, -2)) * scale
                pt = torch.exp(st - lse[:, :, qs].transpose(-1, -2))
                dpt = torch.matmul(vt, dout[:, :, qs].transpose(-1, -2))
                halves.append((pt, pt * (dpt - delta[:, :, qs].transpose(-1, -2))))
            pt = torch.cat([x[0] for x in halves], dim=-1)    # the exchange tiles
            dst = torch.cat([x[1] for x in halves], dim=-1)
            for cw in range(2):           # each warpgroup's 128 output columns
                cols = slice(128 * cw, 128 * cw + 128)
                dv[:, :, k0:k0 + 64, cols] += torch.matmul(pt, dout[:, :, q0:q0 + 64, cols])
                dk[:, :, k0:k0 + 64, cols] += torch.matmul(dst, q[:, :, q0:q0 + 64, cols])
    dq = sum(torch.matmul(ds[..., k0:k0 + 32], kf[:, :, k0:k0 + 32]) for k0 in range(0, l, 32))
    for got, want in zip((dq, dk * scale, dv), (whole[0], whole[1] * scale, whole[2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT_TOL)
