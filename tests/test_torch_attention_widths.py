"""fp32 operands and every head width (the kernels B7 / B8 and B6-f32) against
the JAX package, on the CPU.

* `kernel_for`, the route the card takes by dtype and head width, and
  `generic_body`, B7's and B8's body on the generic route (forward and
  backward apart): their whole table, the refusals included, and the C
  entries the forward and the backward launch by body, width and tier
  (recorded, not run: this runs without a card);
* the one-pass forward's plain version (what B7 computes) at head_dim 16,
  96, 256 and 512, fp32 and bf16, with GQA and RoPE, unbiased and biased:
  against JAX's Pallas kernel in interpret mode at 256 and 512 (multiples
  of 128, which JAX sends to Pallas) and against JAX's `xla_attention` at 16
  and 96 (the function JAX runs at widths Pallas does not take);
* at head_dim 256 in both dtypes: the long tier's forward against
  `flash_attention_online`, and both tiers' backward against
  `flash_attention_bwd` / `flash_attention_bwd_staged`, all in interpret
  mode, called directly at small L (as test_torch_attention_long.py does);
* B6-f32's function: JAX's `int4_matmul(..., interpret=True)` with fp32 x
  against `int4_matmul_reference` with fp32 x, and against B6-f32's split
  schedule (K split in equal parts, the partials summed in the kernel's
  fixed order) emulated in plain PyTorch.

Tolerances: fp32 forward atol 1e-5 (summation order only); fp32 gradients
atol 1e-5 plus rtol 1e-5 of each entry; bf16 at the existing files' bars:
forward atol = rtol = 3e-2 (test_torch_attention.py), backward atol 0.15,
rtol 0.1 (test_torch_attention_bwd.py). B6-f32: atol 1e-5.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops import attention as jax_attention
from mmada_tpu.ops import int4_matmul as JI
from mmada_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_bwd as jax_flash_attention_bwd,
    flash_attention_bwd_staged,
    flash_attention_online,
)
from mmada_tpu_torch.ops import int4_matmul as I
from mmada_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    generic_body,
    kernel_for,
)
from mmada_tpu_torch.ops.flash_attention_long import (
    flash_attention_bwd_long_reference,
    flash_attention_long_reference,
)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"fp32": dict(atol=1e-5, rtol=0), "bf16": dict(atol=3e-2, rtol=3e-2)}
BWD_TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=0.15, rtol=0.1)}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on one torch thread (the driver runs many workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pairs(dtype, *arrays):
    """The same values as JAX arrays and torch tensors of `dtype` (None
    stays None)."""
    jd, td = DTYPES[dtype]
    return ([None if a is None else jnp.asarray(a, jd) for a in arrays],
            [None if a is None else torch.from_numpy(a).to(td) for a in arrays])


def _inputs(b, h, kvh, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, lq, d)).astype(np.float32) * 2.0,
            rng.normal(size=(b, kvh, lk, d)).astype(np.float32),
            rng.normal(size=(b, kvh, lk, d)).astype(np.float32),
            rng.normal(size=(b, h, lq, d)).astype(np.float32))


def _bias(b, h, lq, lk, seed=3):
    return (np.random.default_rng(seed).normal(size=(b, h, lq, lk)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "generic"), (torch.bfloat16, 96, "generic"),
    (torch.bfloat16, 256, "generic"), (torch.bfloat16, 512, "generic"),
    (torch.float32, 16, "generic"), (torch.float32, 64, "generic"),
    (torch.float32, 128, "generic"), (torch.float32, 256, "generic"),
    (torch.float32, 512, "generic"),
    (torch.float16, 128, None), (torch.float64, 64, None), (torch.float32, 8, None),
    (torch.bfloat16, 24, None), (torch.float32, 528, None), (torch.bfloat16, 0, None),
    (torch.bfloat16, 48, "generic"), (torch.bfloat16, 192, "generic"),
    (torch.bfloat16, 240, "generic"), (torch.bfloat16, 272, "generic"),
    (torch.float32, 48, "generic"), (torch.float32, 96, "generic"),
    (torch.float32, 192, "generic"), (torch.float32, 240, "generic"),
    (torch.float32, 272, "generic"), (torch.float16, 48, None), (torch.bfloat16, 520, None),
    (torch.bfloat16, 112, "generic"), (torch.bfloat16, 144, "generic"),
    (torch.float32, 400, "generic"), (torch.bfloat16, 400, "generic"),
])
def test_kernel_for_routes_by_dtype_and_width(dtype, d, want, monkeypatch):
    """The route, and on the generic route B7's and B8's body: B7 "wgmma"
    for bf16 at every width, "ffma" for fp32; B8 "wgmma" for bf16 up to 256,
    "ffma" for fp32 and bf16 past 256; the C entries of the forward
    (`_fwd_entry`) and the backward (`_bwd_entries`) by body and width, both
    tiers."""
    if want is None:
        with pytest.raises(ValueError, match="no attention kernel"):
            kernel_for(dtype, d)
        with pytest.raises(ValueError):
            generic_body(dtype, d)
        with pytest.raises(ValueError):
            generic_body(dtype, d, backward=True)
    else:
        assert kernel_for(dtype, d) == want
    if want == "generic":
        fwd_body = "wgmma" if dtype == torch.bfloat16 else "ffma"
        body = "wgmma" if dtype == torch.bfloat16 and d <= 256 else "ffma"
        assert generic_body(dtype, d) == fwd_body
        assert generic_body(dtype, d, backward=True) == body
        fwd_entry = (("attention_wide", "mmada_attention_wide_fwd_bf16") if fwd_body == "wgmma"
                     else ("attention_generic", "mmada_attention_generic_fwd"))
        for long in (False, True):
            assert _fwd_entry(monkeypatch, dtype, d, long) == (fwd_entry, fwd_body)
            if body == "ffma":
                lib = "attention_generic"
                want_entries = [(lib, "mmada_attention_generic_dq"),
                                (lib, "mmada_attention_generic_dkv")]
            elif d <= 128:   # B3's / B5's kernels at the instance of 64 or 128
                lib = "flash_attention_long" if long else "flash_attention_bwd"
                want_entries = [(lib, f"{lib}{'_bwd' if long else ''}_dq"),
                                (lib, f"{lib}{'_bwd' if long else ''}_dkv")]
            else:
                lib = "attention_wide_bwd"
                want_entries = [(lib, "mmada_attention_wide_dq_bf16"),
                                (lib, "mmada_attention_wide_dkv_bf16")]
            assert _bwd_entries(monkeypatch, dtype, d, long) == (want_entries, body)
    elif want == "wgmma":
        with pytest.raises(ValueError, match="takes the wgmma kernels"):
            generic_body(dtype, d)
        with pytest.raises(ValueError, match="takes the wgmma kernels"):
            generic_body(dtype, d, backward=True)


def _fwd_entry(monkeypatch, dtype, d, long):
    """The C entry (library, name) B7 launches for CPU operands of `dtype`
    and width d handed to the card's launch code (recorded, not run), and
    the body it counted."""
    from mmada_tpu_torch.ops import flash_attention as fa

    launched = []
    monkeypatch.setattr(fa, "_entry", lambda source, name, *a, **k: (source, name))
    monkeypatch.setattr(fa, "_launch", lambda fn, device, *args: launched.append(fn))
    wrapper = types.SimpleNamespace(wgmma_body_launches=0, ffma_body_launches=0,
                                    generic_launches=0, generic_bias_launches=0)
    q, k, v = (torch.zeros((1, 2, 8, d), dtype=dtype) for _ in range(3))
    fa._generic_fwd(wrapper, q, k, v, long_tier=long)
    (entry,) = launched
    bodies = [b for b in ("wgmma", "ffma") if getattr(wrapper, f"{b}_body_launches") == 1]
    assert wrapper.generic_launches == 1
    return entry, bodies[0] if len(bodies) == 1 else bodies


def _bwd_entries(monkeypatch, dtype, d, long):
    """The C entries (library, name) B8-dq and B8-dkv launch for CPU operands
    of `dtype` and width d handed to the card's launch code, the launches
    recorded instead of run (a wgmma entry of B3 / B5 as (library, prefix +
    "_dq" / "_dkv")), and the body both counted."""
    from mmada_tpu_torch.ops import flash_attention as fa

    launched = []
    monkeypatch.setattr(fa, "_entry", lambda source, name, *a, **k: (source, name))
    monkeypatch.setattr(fa, "_launch", lambda fn, device, *args: launched.append(fn))

    def wgmma(kind):
        def record(source, prefix, *args):
            launched.append((source, f"{prefix}_{kind}"))
            return None, None
        return record

    monkeypatch.setattr(fa, "_launch_dq_wgmma", wgmma("dq"))
    monkeypatch.setattr(fa, "_launch_dkv_wgmma", wgmma("dkv"))
    wrapper = types.SimpleNamespace(wgmma_body_launches=0, ffma_body_launches=0)
    q, k, v, dout = (torch.zeros((1, 2, 8, d), dtype=dtype) for _ in range(4))
    stats = torch.zeros((1, 2, 8))
    fa._generic_dq(wrapper, q, k, v, dout, stats, long_tier=long)
    fa._generic_dkv(wrapper, q, k, v, dout, stats, stats, long_tier=long)
    bodies = {b for b in ("wgmma", "ffma") if getattr(wrapper, f"{b}_body_launches") == 2}
    return launched, bodies.pop() if len(bodies) == 1 else bodies


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("d", [16, 96, 256, 512])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_one_pass_forward_at_every_width(dtype, d, biased):
    b, h, kvh, l = 1, 4, 2, 136
    q, k, v, _ = _inputs(b, h, kvh, l, l, d)
    bias = _bias(b, h, l, l) if biased else None
    sin, cos = jax_llada.rope_sin_cos(l, d, 10000.0)
    (jq, jk, jv), (tq, tk, tv) = _pairs(dtype, q, k, v)
    jb, tb = (None, None) if bias is None else (jnp.asarray(bias), torch.from_numpy(bias))
    if d % 128 == 0:
        want = jax_flash_attention(jq, jk, jv, bias=jb, rope_sin=sin, rope_cos=cos,
                                   interpret=True)
    else:
        rq, rk = jax_attention.apply_rope(jq, jk, sin, cos)
        want = jax_attention.xla_attention(rq, rk, jv, bias=jb)
    tsin, tcos = torch.from_numpy(np.array(sin)), torch.from_numpy(np.array(cos))
    got = flash_attention_reference(tq, tk, tv, rope_sin=tsin, rope_cos=tcos, bias=tb)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL[dtype])
    # a CPU tensor takes the plain version through the wrapper
    torch.testing.assert_close(
        flash_attention(tq, tk, tv, rope_sin=tsin, rope_cos=tcos, bias=tb), got, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rectangular_forward_at_width_96(dtype):
    """Lq != Lk (no RoPE) with a broadcast bias: the block-KV step's shape."""
    q, k, v, _ = _inputs(2, 4, 4, 48, 120, 96, seed=4)
    bias = _bias(2, 1, 48, 120)
    (jq, jk, jv), (tq, tk, tv) = _pairs(dtype, q, k, v)
    want = jax_attention.xla_attention(jq, jk, jv, bias=jnp.asarray(bias))
    got = flash_attention_reference(tq, tk, tv, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_long_tier_at_width_256(dtype):
    """B7-long's and B8's long functions at D 256 against JAX's online
    forward and staged backward (interpret mode), with GQA and a bias."""
    b, h, kvh, l, d = 1, 2, 1, 256, 256
    q, k, v, ct = _inputs(b, h, kvh, l, l, d, seed=5)
    bias = _bias(b, h, l, l, seed=6)
    (jq, jk, jv, jct), (tq, tk, tv, tct) = _pairs(dtype, q, k, v, ct)
    jb, tb = jnp.asarray(bias), torch.from_numpy(bias)
    want = flash_attention_online(jq, jk, jv, bias=jb, block_q=128, block_k=128, interpret=True)
    out = flash_attention_long_reference(tq, tk, tv, tb)
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL[dtype])
    jout = jnp.asarray(_np(out), jq.dtype)
    want = flash_attention_bwd_staged(jq, jk, jv, jout, jct, bias=jb, block_q=128, block_k=128,
                                      interpret=True)
    got = flash_attention_bwd_long_reference(tq, tk, tv, out, tct, tb)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(_np(g), _np(w), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_one_pass_backward_at_width_256(dtype):
    """B8-dq's and B8-dkv's one-pass functions at D 256 against JAX's
    `flash_attention_bwd` (interpret mode), GQA, rectangular."""
    b, h, kvh, lq, lk, d = 1, 2, 1, 136, 200, 256
    q, k, v, ct = _inputs(b, h, kvh, lq, lk, d, seed=7)
    (jq, jk, jv, jct), (tq, tk, tv, tct) = _pairs(dtype, q, k, v, ct)
    out = flash_attention_reference(tq, tk, tv)
    want = jax_flash_attention_bwd(jq, jk, jv, jnp.asarray(_np(out), jq.dtype), jct,
                                   interpret=True)
    got = flash_attention_bwd_reference(tq, tk, tv, out, tct)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(_np(g), _np(w), **BWD_TOL[dtype])


@pytest.mark.parametrize("m,k,n", [(33, 1024, 384)])
def test_int4_with_fp32_x_matches_the_pallas_kernel(m, k, n):
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jp, js = JI.pack_int4(jnp.asarray(w))
    p, s = I.pack_int4(torch.from_numpy(w))
    want = JI.int4_matmul(jnp.asarray(x), jp, js, interpret=True)
    got = I.int4_matmul(torch.from_numpy(x), p, s)   # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("m,k,n,splits", [(33, 1024, 384, 4), (130, 2048, 256, 8)])
def test_int4_split_sums_match_the_pallas_kernel(m, k, n, splits):
    """B6-f32's schedule where the output tiles are few (`f32_splits`): K
    cut into `splits` equal parts of whole 128-row groups, each part's fp32
    partial x[:, K_z] @ W[K_z], the partials summed in the order 0, 1, ...
    as the kernel's second pass sums them; against JAX's kernel within the
    fp32 bar."""
    rng = np.random.default_rng(k + splits)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jp, js = JI.pack_int4(jnp.asarray(w))
    p, s = I.pack_int4(torch.from_numpy(w))
    want = JI.int4_matmul(jnp.asarray(x), jp, js, interpret=True)
    xt, wt = torch.from_numpy(x), I.unpack_int4(p, s, torch.float32)
    step = k // splits
    assert step % I.GROUP == 0
    got = xt[:, :step] @ wt[:step]
    for z in range(1, splits):
        got = got + xt[:, z * step:(z + 1) * step] @ wt[z * step:(z + 1) * step]
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
