"""Tests of the port that need the card: the Hopper kernels (unbiased and
biased, the one-pass tier and the long tier; the int4 matmul B6) against
their plain versions, their refusals, the routing by length, gradients
through attention, the served and trained paths through the kernels (with
masks too, on a frame past 4096 tokens, and on int4 weights), the W8A8
int8 product on the card, an fp32 model on the card against the CPU, the
CUDA-core kernels (B7, B8, B6-f32) at fp32 and at every head width and
`kernel_for`'s routes, the launches'
device, MAGVIT-v2 on the card (against the CPU, whatever the TF32 flags) and
MMU requests through B1 alone, the serving engine's batches, streams and
t2i windows.

They skip without a CUDA device (the kernel has no CPU mode). This file
imports neither jax nor the JAX package, so it also runs beside the card,
where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

import dataclasses

from mmada_tpu_torch.core.precision import BF16, FP32, exact_bf16_reductions
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import decode_images, quantize, serve_mmu, serve_t2i, serve_text, train
from mmada_tpu_torch.models import llada, magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops.attention import KernelAttention, bidirectional_attention
from mmada_tpu_torch.ops.flash_attention import (
    attention_bwd_dkv,
    attention_bwd_dkv_reference,
    attention_bwd_dq,
    attention_bwd_dq_reference,
    attention_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_reference,
    generic_body,
)
from mmada_tpu_torch.ops.flash_attention_long import (
    attention_bwd_dkv_long,
    attention_bwd_dkv_long_reference,
    attention_bwd_dq_long,
    attention_bwd_dq_long_reference,
    flash_attention_bwd_long,
    flash_attention_bwd_long_reference,
    flash_attention_long,
    flash_attention_long_reference,
)
from mmada_tpu_torch.ops import quantization as Q
from mmada_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_reference, pack_int4
from mmada_tpu_torch.prompting.universal import SpecialIds

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(device, b, h, kvh, lq, lk, d, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(b, h, lq, d, generator=g, device=device).bfloat16() * 3
    k = torch.randn(b, kvh, lk, d, generator=g, device=device).bfloat16()
    v = torch.randn(b, kvh, lk, d, generator=g, device=device).bfloat16()
    return q, k, v


# B1 normalises p in fp32 before its bf16 cast, as its plain version does:
# besides atol/rtol 3e-2, at most 5% of its bf16 outputs may differ from the
# plain version's (an online softmax that divided at the end moves about half)
B1_DIFFER_SHARE = 0.05


def assert_b1_close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    share = float((got != want).float().mean())
    assert share <= B1_DIFFER_SHARE, share


@pytest.mark.parametrize("b,h,kvh,lq,lk,rope,d", [
    (2, 4, 4, 1155, 1155, True, 128),   # unaligned t2i frame
    (1, 8, 2, 200, 200, True, 64),      # GQA, head_dim 64
    (2, 4, 4, 100, 333, False, 128),    # rectangular
    (1, 2, 2, 1, 1, True, 128),         # one token
    (1, 2, 1, 4096, 4096, True, 128),   # the one-pass tier's longest
    # ragged edges: TMA zero-fills rows past Lq and keys past Lk, the kernel
    # scores those keys -inf and the store drops those rows
    (1, 4, 4, 63, 63, True, 128), (1, 4, 4, 64, 64, True, 128),
    (1, 4, 4, 65, 65, True, 128), (1, 4, 4, 127, 127, True, 128),
    (1, 4, 4, 129, 129, True, 128),
    (1, 4, 4, 4097, 4097, True, 128),   # past 4096, unaligned: the one-pass tier
    (1, 4, 4, 65, 1155, False, 128), (1, 4, 4, 1155, 129, False, 128),
    (1, 4, 4, 4097, 127, False, 128),   # rectangular, ragged
    (2, 8, 2, 1155, 1155, True, 128),   # GQA 4:1
    (1, 8, 1, 300, 300, True, 128),     # one kv head
    (2, 8, 4, 333, 333, True, 64),
    (1, 4, 2, 129, 640, False, 64),     # rectangular, GQA, head_dim 64
])
def test_kernel_matches_plain_version(cuda_device, b, h, kvh, lq, lk, rope, d):
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, d)
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(lq, d, 500000.0, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_b1_close(got, want)


def test_b1_copies_an_operand_no_tensor_map_describes(cuda_device):
    """Strided columns (every other element) are copied before the launch."""
    q, k, v = _qkv(cuda_device, 1, 2, 2, 200, 200, 256)
    q, k, v = (t[..., ::2] for t in (q, k, v))
    assert q.stride(-1) == 2
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got, flash_attention(q.contiguous(), k.contiguous(),
                                                    v.contiguous()), atol=0, rtol=0)


def test_wgmma_tile_loaded_by_tma_matches_torch_matmul(cuda_device):
    """One tile through the kernels' path: TMA loads with the 128-byte
    swizzle, s = a . b^T from shared memory (K-major), o = bf16(s) . v with
    s from registers and v MN-major. Then the roles the backward kernels
    (B5-dq, B5-dkv) add, at D 64 and 128: the A operand from the second 64
    rows of a 128-row tile, and one 64-row streamed tile read both ways,
    K-major for s = x[64:] . y^T (as k in B5-dq's scores, q and dO in
    B5-dkv's) and MN-major for o = bf16(s) . y (as k in t . k, q and dO in
    ds^T . q and p^T . dO). A map and a descriptor that disagree on the
    swizzle, or a wrong descriptor offset, run and return wrong numbers."""
    from mmada_tpu_torch.ops.tensor_maps import wgmma_bwd_tile_product, wgmma_tile_product

    g = torch.Generator(cuda_device).manual_seed(3)
    a = torch.randn(64, 128, generator=g, device=cuda_device).bfloat16()
    b = torch.randn(128, 128, generator=g, device=cuda_device).bfloat16()
    v = torch.randn(128, 128, generator=g, device=cuda_device).bfloat16()
    s, o = wgmma_tile_product(a, b, v)
    # bf16 products are exact in fp32; only the order of the fp32 sums differs
    torch.testing.assert_close(s, torch.matmul(a.float(), b.float().T), atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(o, torch.matmul(s.bfloat16().float(), v.float()), atol=1e-2,
                               rtol=1e-5)
    for d in (64, 128):
        x = torch.randn(128, d, generator=g, device=cuda_device).bfloat16()
        y = torch.randn(64, d, generator=g, device=cuda_device).bfloat16()
        s, o = wgmma_bwd_tile_product(x, y)
        torch.testing.assert_close(s, torch.matmul(x[64:].float(), y.float().T), atol=1e-3,
                                   rtol=1e-5)
        torch.testing.assert_close(o, torch.matmul(s.bfloat16().float(), y.float()),
                                   atol=1e-2, rtol=1e-5)


@pytest.mark.parametrize("kvh,d,rope", [(4, 128, False), (2, 128, True), (2, 64, False)])
def test_kernel_takes_strided_views(cuda_device, kvh, d, rope):
    """q/k/v as head views of one (B, L, (H + 2 KVH) D) projection, as the
    model's fused att_proj gives them: read in place through the tensor
    maps, the same bits as contiguous inputs, and the plain version's bars."""
    b, l, h = 2, 300, 4
    g = torch.Generator(cuda_device).manual_seed(1)
    fused = torch.randn(b, l, (h + 2 * kvh) * d, generator=g, device=cuda_device).bfloat16()
    q, k, v = fused.split([h * d, kvh * d, kvh * d], dim=-1)
    q = q.view(b, l, h, d).transpose(1, 2)
    k = k.view(b, l, kvh, d).transpose(1, 2)
    v = v.view(b, l, kvh, d).transpose(1, 2)
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(l, d, 500000.0, device=cuda_device)
    got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), rope_sin=sin,
                           rope_cos=cos)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert_b1_close(got, flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos))


def test_kernel_refuses_what_it_cannot_take(cuda_device):
    """A CUDA tensor launches the kernel or raises; nothing falls back."""
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 128)
    before = flash_attention.launches
    with pytest.raises(TypeError):   # fp16: no kernel (kernel_for)
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):   # head_dim 8: no kernel (kernel_for)
        flash_attention(q[..., :8], k[..., :8], v[..., :8])
    # misaligned (a 2-byte offset): B1 and B2 copy what a tensor map cannot
    # describe and give the contiguous copy's result
    odd = [t[..., 1:65] for t in (q, k, v)]
    dense = [t.contiguous() for t in odd]
    torch.testing.assert_close(flash_attention(*odd), flash_attention(*dense), atol=0, rtol=0)
    zero = torch.zeros(1, 1, 64, 64, device=cuda_device)
    torch.testing.assert_close(flash_attention(*odd, bias=zero),
                               flash_attention(*dense, bias=zero), atol=0, rtol=0)
    sin, cos = llada.rope_sin_cos(64, 128, 500000.0, device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :32], v[:, :, :32], rope_sin=sin, rope_cos=cos)
    before_bias = flash_attention.bias_launches
    with pytest.raises(ValueError):   # a bias of the wrong shape
        flash_attention(q, k, v, bias=torch.zeros(1, 1, 64, 32, device=cuda_device))
    with pytest.raises(ValueError):   # a bias on another device
        flash_attention(q, k, v, bias=torch.zeros(1, 1, 64, 64))
    long_q = torch.zeros(1, 1, 4224, 128, dtype=torch.bfloat16, device=cuda_device)
    before_long = (flash_attention_long.launches, flash_attention_long.bias_launches)
    # rectangular past 4096: B1 once (the one-pass tier), never B4
    lq, lk, lv = _qkv(cuda_device, 1, 1, 1, 4224, 300, 128, seed=3)
    assert_b1_close(bidirectional_attention(lq, lk, lv), flash_attention_reference(lq, lk, lv))
    with pytest.raises(ValueError):   # the long tier takes 128-aligned lengths
        flash_attention_long(long_q[:, :, :4200], long_q[:, :, :4200], long_q[:, :, :4200])
    with pytest.raises(TypeError):
        flash_attention_long(long_q.half(), long_q.half(), long_q.half())
    assert (flash_attention_long.launches, flash_attention_long.bias_launches) == before_long
    # the misaligned call and its copy, and the rectangular call past 4096
    assert flash_attention.launches == before + 3
    assert flash_attention.bias_launches == before_bias


def test_served_requests_go_through_the_kernel(cuda_device):
    """A small bf16 model on the card: every text step and t2i step runs the
    kernel once per layer."""
    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=128, n_heads=2)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0),
                            policy=BF16)
    before = flash_attention.launches
    answers = serve_text(model, ["abc", "xyz"], gen_length=16, steps=8, block_length=8)
    assert flash_attention.launches - before == cfg.n_layers * 8
    assert all((a != vocab.mask_token_id).all() for a in answers)
    t = vocab.text_vocab_size
    sp = SpecialIds(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16,
                    t2m=t - 15, som=t - 14, eom=t - 13, pad=vocab.pad_token_id,
                    bos=vocab.bos_token_id, eos=vocab.eos_token_id)
    before = flash_attention.launches
    codes = serve_t2i(model, ["a cat", "a dog"], special_ids=sp, num_vq_tokens=16,
                      max_text_len=8, timesteps=4, guidance_scale=2.0)
    assert flash_attention.launches - before == cfg.n_layers * 4
    assert codes.shape == (2, 16)
    assert ((codes >= 0) & (codes < vocab.image_codebook_size)).all()


# bf16 gradients: p and ds enter the tensor cores rounded to bf16 (2^-9
# relative per term) and the outputs are bf16; held normwise, and elementwise
# against the largest entry (cancellation makes a per-element relative bar
# meaningless where a gradient entry is near 0). Where the exact gradient is
# 0 (one key: p = 1, so ds = dp - delta = 0) the scale is an absolute floor,
# per entry, far below the unit-scale dO and v the cases draw
GRAD_REL_L2 = 1e-2
GRAD_MAX_REL = 2e-2
GRAD_ABS_FLOOR = 1e-3


def assert_grad_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    norm = max(float(want.norm()), GRAD_ABS_FLOOR * want.numel() ** 0.5)
    rel = float((got - want).norm()) / norm
    worst = float((got - want).abs().max()) / max(float(want.abs().max()), GRAD_ABS_FLOOR)
    assert rel <= GRAD_REL_L2 and worst <= GRAD_MAX_REL, (rel, worst)


@pytest.mark.parametrize("b,h,kvh,lq,lk,d", [
    (2, 4, 4, 388, 388, 128),   # an unaligned training frame
    (1, 8, 2, 200, 200, 64),    # GQA, head_dim 64
    (2, 4, 4, 100, 333, 128),   # rectangular
    (1, 2, 2, 1, 7, 128),       # one query row
    (1, 2, 2, 1, 1, 128),       # one query, one key: dq = dk = 0 exactly
    (1, 4, 1, 1155, 1155, 128), # GQA 4:1 at the t2i frame
    (2, 4, 4, 129, 129, 128),   # a tail of one row and one key past a 128 tile
    (3, 4, 4, 387, 387, 128),   # the stage-1 frame: a tail of 3 past 3 x 128
    (1, 8, 2, 387, 387, 64),    # the stage-1 frame, GQA, head_dim 64
    (1, 4, 2, 1, 387, 64),      # one query row over the stage-1 keys
    (1, 4, 4, 4097, 4097, 128), # an unaligned frame past 4096 (the one-pass route)
    # more (tile pair, head, batch) items than B3-dq's persistent grid has
    # clusters, so each cluster walks several
    (15, 8, 8, 387, 387, 128),
    (16, 8, 2, 387, 387, 64),   # the same with GQA, head_dim 64
])
def test_backward_kernels_match_plain_versions(cuda_device, b, h, kvh, lq, lk, d):
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, d)
    g = torch.Generator(cuda_device).manual_seed(5)
    out = flash_attention(q, k, v)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    delta = attention_delta(out, dout)
    before = (attention_bwd_dq.launches, attention_bwd_dkv.launches)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta)
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want_dq, want_lse = attention_bwd_dq_reference(q, k, v, dout, delta)
    want_dk, want_dv = attention_bwd_dkv_reference(q, k, v, dout, want_lse, delta)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert_grad_close(got, want)


@pytest.mark.parametrize("b,h,kvh,l,d", [(3, 8, 8, 387, 128), (2, 8, 2, 129, 64)])
def test_backward_kernels_repeat_bit_for_bit(cuda_device, b, h, kvh, l, d):
    """Two identical calls of B3's dq and dkv give the same bits: the lse
    and delta spans, read from shared memory with ordinary loads, are fenced
    before their slot's next TMA load (a race there gave other bits from run
    to run in the biased B5-dq)."""
    q, k, v = _qkv(cuda_device, b, h, kvh, l, l, d)
    out = flash_attention(q, k, v)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(11),
                       device=cuda_device).bfloat16()
    delta = attention_delta(out, dout)
    runs = []
    for _ in range(2):
        dq, lse = attention_bwd_dq(q, k, v, dout, delta)
        runs.append((dq, lse, *attention_bwd_dkv(q, k, v, dout, lse, delta)))
    for a, b_ in zip(*runs):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)


def test_backward_kernels_take_strided_views(cuda_device):
    """dO as the head view of a (B, L, H*D) gradient, as the model's
    backward hands it over: no copy, same result as a contiguous dO."""
    b, l, h, d = 2, 300, 4, 128
    q, k, v = _qkv(cuda_device, b, h, h, l, l, d)
    g = torch.Generator(cuda_device).manual_seed(2)
    flat = torch.randn(b, l, h * d, generator=g, device=cuda_device).bfloat16()
    dout = flat.view(b, l, h, d).transpose(1, 2)
    out = flash_attention(q, k, v)
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta)
    dq2, lse2 = attention_bwd_dq(q, k, v, dout.contiguous(), delta)
    torch.testing.assert_close(dq, dq2, atol=0, rtol=0)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta)
    dk2, dv2 = attention_bwd_dkv(q, k, v, dout.contiguous(), lse2, delta)
    torch.testing.assert_close((dk, dv), (dk2, dv2), atol=0, rtol=0)


@pytest.mark.parametrize("rope,kvh,lq,lk", [(True, 4, 388, 388), (True, 2, 300, 300),
                                            (False, 4, 256, 500)])
def test_attention_is_differentiable_on_cuda(cuda_device, rope, kvh, lq, lk):
    """The repaired fault: on the card the output of `bidirectional_attention`
    has a grad_fn, and its gradients (backward kernels, RoPE pulled back in
    fp32) equal those of the CPU path (the plain versions) on the same
    values."""
    h, d = 4, 128
    q, k, v = _qkv(cuda_device, 2, h, kvh, lq, lk, d)
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(lq, d, 500000.0, device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(3)
    dout = torch.randn(2, h, lq, d, generator=g, device=cuda_device).bfloat16()

    def grads(device):
        ins = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        tables = [None if t is None else t.to(device) for t in (sin, cos)]
        out = bidirectional_attention(*ins, rope_sin=tables[0], rope_cos=tables[1])
        assert out.grad_fn is not None
        return torch.autograd.grad(out, ins, dout.to(device))

    before = (attention_bwd_dq.launches, attention_bwd_dkv.launches)
    got = grads(cuda_device)
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b_ in zip(got, grads("cpu")):
        assert a.dtype == torch.bfloat16
        assert_grad_close(a.cpu(), b_)


def test_backward_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 128)
    out = flash_attention(q, k, v)
    delta = attention_delta(out, q)
    with pytest.raises(TypeError):
        attention_bwd_dq(q.half(), k.half(), v.half(), q.half(), delta)
    with pytest.raises(ValueError):
        attention_bwd_dq(q, k, v, q, delta.double())
    with pytest.raises(ValueError):
        attention_bwd_dq(q[..., :8], k[..., :8], v[..., :8], q[..., :8], delta)


def test_backward_past_the_one_pass_range_names_b5(cuda_device):
    """Past 4096 tokens the routing takes the long tier for 128-aligned
    lengths (B4 forward, B5-dq and B5-dkv backward) and the one-pass tier
    otherwise (B1, B3: JAX's XLA function there), as rectangular attention
    that long does (the block-KV decode's step), matching the plain
    version."""
    kernels = (flash_attention, attention_bwd_dq, attention_bwd_dkv, flash_attention_long,
               attention_bwd_dq_long, attention_bwd_dkv_long)

    def launched(l, lk=None):
        q = torch.zeros(1, 2, l, 128, dtype=torch.bfloat16, device=cuda_device,
                        requires_grad=True)
        k = torch.zeros(1, 2, lk or l, 128, dtype=torch.bfloat16, device=cuda_device,
                        requires_grad=True)
        before = [f.launches for f in kernels]
        try:
            bidirectional_attention(q, k, k).sum().backward()
        finally:
            after = [f.launches for f in kernels]
        return tuple(a - b for a, b in zip(after, before))

    assert launched(4097) == (1, 1, 1, 0, 0, 0)
    assert launched(4224) == (0, 0, 0, 1, 1, 1)
    assert launched(4096) == (1, 1, 1, 0, 0, 0)
    assert launched(4224, 4352) == (1, 1, 1, 0, 0, 0)
    assert launched(64, 8192) == (1, 1, 1, 0, 0, 0)
    q, k, v = _qkv(cuda_device, 1, 4, 2, 64, 8256, 128, seed=5)
    before = (flash_attention.launches, flash_attention_long.launches)
    assert_b1_close(bidirectional_attention(q, k, v), flash_attention_reference(q, k, v))
    assert (flash_attention.launches, flash_attention_long.launches) == (before[0] + 1,
                                                                          before[1])


def test_train_steps_go_through_the_kernels(cuda_device):
    """A 2-layer bf16 model with head_dim 128 and full remat, trained through
    `entry.train`: each step runs the forward kernel twice per layer (the
    forward and its recompute) and each backward kernel once per layer, with
    finite metrics, and the weights change."""
    import numpy as np

    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0),
                            policy=BF16, remat="full")
    before = model.params["blocks"]["q_proj"].clone()
    t = vocab.text_vocab_size
    sp = SpecialIds(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16,
                    t2m=t - 15, som=t - 14, eom=t - 13, pad=vocab.pad_token_id,
                    bos=vocab.bos_token_id, eos=vocab.eos_token_id)
    rng = np.random.default_rng(0)
    flows = {"t2i_flow": {"input_ids": ["a cat", "a dog"], "image_codes": rng.integers(0, 64, (2, 100))},
             "lm_flow": {"input_ids": ["hello there", "general"]},
             "mmu_flow": {"input_ids": ["what?", "who?"], "image_codes": rng.integers(0, 64, (2, 100))}}
    counts = (flash_attention.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches)
    trainer = train(model, [flows], steps=2, special_ids=sp, max_text_len=16,
                    training=dict(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2,
                                  loss_chunk=64),
                    lr_scheduler={"scheduler": "constant", "params": {"learning_rate": 1e-3}})
    launched = tuple(c - c0 for c, c0 in zip(
        (flash_attention.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches), counts))
    assert launched == (2 * 2 * cfg.n_layers, 2 * cfg.n_layers, 2 * cfg.n_layers)
    assert int(trainer.state.step) == 2
    for h in trainer.history:
        assert all(np.isfinite(v) for v in h.values()) and h["skipped_nonfinite"] == 0
    assert not torch.equal(model.params["blocks"]["q_proj"], before)


# ------------------------------------------------------------------ biased

def _mask_bias(device, b, l, n_pad, seed=0):
    """The (B, 1, L, L) fp32 bias a (B, L) keep-mask gives: each row's first
    n_pad + row positions padded (masked out), as a padded prompt frame. The
    padded query rows have no allowed key."""
    mask = torch.ones(b, l, dtype=torch.long, device=device)
    for row in range(b):
        mask[row, :n_pad + row] = 0
    return llada.prepare_attention_bias(mask), mask


def _bias(device, kind, b, h, lq, lk, seed=7):
    g = torch.Generator(device).manual_seed(seed)
    if kind == "mask":
        return _mask_bias(device, b, lq, 5)[0]
    shape = {"head": (b, h, lq, lk), "batch": (b, 1, lq, lk), "one": (1, 1, lq, lk),
             "head-only": (1, h, lq, lk)}[kind]
    return torch.randn(shape, generator=g, device=device) * 2.0


@pytest.mark.parametrize("kind,b,h,kvh,lq,lk,rope,d", [
    ("mask", 2, 4, 4, 1155, 1155, True, 128),     # a padded t2i frame, rows fully masked
    ("head", 1, 4, 4, 333, 333, True, 128),       # per-head float bias, unaligned
    ("batch", 2, 8, 2, 200, 200, True, 64),       # GQA, head_dim 64
    ("one", 2, 4, 4, 100, 333, False, 128),       # rectangular, one bias for all
    ("head-only", 2, 4, 4, 70, 70, True, 128),    # broadcast over the batch only
])
def test_biased_kernel_matches_plain_version(cuda_device, kind, b, h, kvh, lq, lk, rope, d):
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, d)
    bias = _bias(cuda_device, kind, b, h, lq, lk)
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(lq, d, 500000.0, device=cuda_device)
    before = (flash_attention.launches, flash_attention.bias_launches)
    got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    assert (flash_attention.launches, flash_attention.bias_launches) == (
        before[0], before[1] + 1)
    want = flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_b1_close(got, want)   # B2 normalises p before its cast, as B1


def test_bool_bias_equals_its_float_form(cuda_device):
    q, k, v = _qkv(cuda_device, 2, 4, 4, 150, 150, 128)
    allowed = torch.rand(2, 1, 150, 150, device=cuda_device) < 0.7
    from_bool = flash_attention(q, k, v, bias=allowed)
    as_float = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)
    torch.testing.assert_close(from_bool, flash_attention(q, k, v, bias=as_float),
                               atol=0, rtol=0)


@pytest.mark.parametrize("rope,d,lq,lk", [(True, 128, 1155, 1155), (False, 128, 1155, 1155),
                                            (True, 64, 387, 387), (False, 128, 100, 333)])
def test_zero_bias_gives_b1_bit_for_bit(cuda_device, rope, d, lq, lk):
    """B2 with a zero bias is B1, bit for bit: it adds the bias in log2 units
    to B1's exponent (adding 0.0f changes nothing) and sums a row's exps over
    B1's 128-key groups; so with a zero bias of any broadcast shape."""
    q, k, v = _qkv(cuda_device, 2, 4, 2, lq, lk, d)
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(lq, d, 500000.0, device=cuda_device)
    zero = torch.zeros(2, 1, lq, lk, device=cuda_device)
    want = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos)
    for bias in (zero, zero[:1, :1], torch.zeros(2, 4, lq, lk, device=cuda_device)):
        got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_bias_tile_loaded_by_tma_is_read_as_the_kernels_read_it(cuda_device):
    """The fp32 bias tile through the biased kernels' path: TMA loads with
    the 128-byte swizzle in boxes of 32 columns, then the reads the kernels
    make (the same helpers): row-wise for B2's and B5-dq-bias's scores
    (128 rows x 64 keys) and transposed for B5-dkv-bias's k . q^T (64 query
    rows x 128 keys, the key as the accumulator row). A swizzle the map and
    the reads disagree on returns the values in the wrong places."""
    from mmada_tpu_torch.ops.tensor_maps import bias_tile_read

    g = torch.Generator(cuda_device).manual_seed(4)
    rows = torch.randn(128, 64, generator=g, device=cuda_device)
    torch.testing.assert_close(bias_tile_read(rows, transposed=False), rows, atol=0, rtol=0)
    cols = torch.randn(64, 128, generator=g, device=cuda_device)
    torch.testing.assert_close(bias_tile_read(cols, transposed=True), cols.T, atol=0, rtol=0)


def test_biased_kernel_copies_a_bias_no_map_describes(cuda_device):
    """B2 reads a bias through TMA: one whose rows are not 16 bytes apart
    (odd Lk, contiguous) is copied once per call into padded rows
    (`flash_attention.bias_copies`) and gives the bits the padded view gives;
    the model's bias (`prepare_attention_bias`) is read as it is."""
    from mmada_tpu_torch.ops.tensor_maps import aligned_rows

    q, k, v = _qkv(cuda_device, 2, 4, 4, 333, 333, 128)
    bias = torch.randn(2, 1, 333, 333, generator=torch.Generator(cuda_device).manual_seed(8),
                       device=cuda_device)
    before = flash_attention.bias_copies
    got = flash_attention(q, k, v, bias=bias)
    assert flash_attention.bias_copies == before + 1
    want = flash_attention(q, k, v, bias=aligned_rows(bias))
    assert flash_attention.bias_copies == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    model_bias, _ = _mask_bias(cuda_device, 2, 333, 9)
    flash_attention(q, k, v, bias=model_bias)
    assert flash_attention.bias_copies == before + 1


def test_fully_masked_rows_average_v(cuda_device):
    """A query row that the mask shuts out entirely (every bias the finite
    min): B2 averages v over the Lk keys (the XLA tier's function; p =
    1/Lk before its bf16 cast), and in the long tier B5-dq gives p = 1/Lk and
    lse the finite min, B5-dkv p = 1 on each key; with a cotangent on those
    rows too, dq, dk and dv are finite and meet their plain versions' bars."""
    b, h, l = 2, 4, 1155
    q, k, v = _qkv(cuda_device, b, h, h, l, l, 128)
    bias, mask = _mask_bias(cuda_device, b, l, 40)
    sin, cos = llada.rope_sin_cos(l, 128, 500000.0, device=cuda_device)
    out = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    p = torch.tensor(1.0 / l).bfloat16().float()
    mean = (p * v.float()).sum(dim=2, keepdim=True).expand(b, h, l, 128)
    dead = (mask == 0)[:, None, :, None].expand(b, h, l, 128)
    assert dead.any()
    torch.testing.assert_close(out.float()[dead], mean[dead], atol=3e-2, rtol=3e-2)

    l = 4224
    q, k, v = _qkv(cuda_device, 1, 2, 2, l, l, 128)
    bias, mask = _mask_bias(cuda_device, 1, l, 70)
    out = flash_attention_long(q, k, v, bias)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(9),
                       device=cuda_device).bfloat16()
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq_long(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv_long(q, k, v, dout, lse, delta, bias)
    want_dq, want_lse = attention_bwd_dq_long_reference(q, k, v, dout, delta, bias)
    want_dk, want_dv = attention_bwd_dkv_long_reference(q, k, v, dout, want_lse, delta, bias)
    rows = mask[0] == 0
    assert bool((lse[..., rows] == torch.finfo(torch.float32).min).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert_long_grad_close(got, want)


def test_b2_counts_biases_past_the_log2_range_as_the_mask(cuda_device):
    """B2 adds the bias in log2 units saturated at the finite min, so every
    bias at or below -FLT_MAX / log2 e counts as the mask's -FLT_MAX (see
    `flash_attention`): a row whose keys mix -3e38 and -FLT_MAX averages v
    over all its keys, and B2 gives, bit for bit, what it gives with those
    biases set to -FLT_MAX, within B1's bars of the plain version on that
    bias. Rows with a key above the threshold keep the plain version's
    function on the bias as given."""
    b, h, l = 1, 2, 200
    q, k, v = _qkv(cuda_device, b, h, h, l, l, 128)
    bias = _bias(cuda_device, "one", b, h, l, l)
    lowest = torch.finfo(torch.float32).min
    keys = torch.arange(l, device=cuda_device)
    bias[0, 0, :100] = torch.where(keys % 2 == 0, -3e38, lowest)
    bias[0, 0, 50:100, 7] = 0.0   # one allowed key on rows 50-99
    saturated = torch.where(bias * 1.4426950408889634 <= lowest, lowest, bias)
    got = flash_attention(q, k, v, bias=bias)
    torch.testing.assert_close(got, flash_attention(q, k, v, bias=saturated), atol=0, rtol=0)
    assert_b1_close(got, flash_attention_reference(q, k, v, bias=saturated))
    p = torch.tensor(1.0 / l).bfloat16().float()
    mean = (p * v.float()).sum(dim=2, keepdim=True).expand(b, h, 50, 128)
    torch.testing.assert_close(got[:, :, :50].float(), mean, atol=3e-2, rtol=3e-2)
    assert_b1_close(got[:, :, 50:], flash_attention_reference(q, k, v, bias=bias)[:, :, 50:])


def test_biased_kernels_take_strided_views(cuda_device):
    """Head views of (B, L, H*D) projections and a bias that is an expanded
    view (0 strides) give what contiguous copies give."""
    b, l, h, d = 2, 300, 4, 128
    g = torch.Generator(cuda_device).manual_seed(1)
    fused = torch.randn(b, l, 3 * h * d, generator=g, device=cuda_device).bfloat16()
    q, k, v = (t.view(b, l, h, d).transpose(1, 2) for t in fused.split(h * d, dim=-1))
    row = torch.randn(1, 1, l, l, generator=g, device=cuda_device)
    view = row.expand(b, h, l, l)
    got = flash_attention(q, k, v, bias=view)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias=row)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    dout = torch.randn(b, l, h * d, generator=g, device=cuda_device).bfloat16()
    dout = dout.view(b, l, h, d).transpose(1, 2)
    got = flash_attention_bwd(q, k, v, want, dout, bias=view)
    want = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), want,
                               dout.contiguous(), bias=row)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("kind,b,h,kvh,lq,lk,d", [
    ("mask", 3, 4, 4, 387, 387, 128),   # the stage-1 frame with padded t2i rows
    ("head", 1, 4, 4, 333, 333, 128),
    ("batch", 1, 8, 2, 200, 200, 64),   # GQA, head_dim 64
    ("one", 2, 4, 4, 100, 333, 128),    # rectangular
    ("mask", 1, 4, 1, 1155, 1155, 128), # GQA 4:1 at the t2i frame
    # ragged edges: keys past Lk (not a multiple of 64) must be masked after
    # the bias is added, since TMA zero-fills K and the bias there
    ("mask", 2, 4, 4, 129, 129, 128),   # a tail of one row and one key past a 128 tile
    ("one", 1, 4, 4, 1, 387, 128),      # one query row over the stage-1 keys
    ("head", 2, 4, 4, 387, 129, 128),   # rectangular, Lq > Lk
    ("mask", 1, 8, 2, 387, 387, 64),    # the stage-1 frame, GQA 8:2, head_dim 64
    # more (tile pair, head, batch) items than the dq kernel's persistent
    # grid has clusters, so each cluster walks several
    ("mask", 15, 8, 8, 387, 387, 128),
    ("head", 16, 8, 2, 387, 387, 64),
])
def test_biased_backward_kernels_match_plain_versions(cuda_device, kind, b, h, kvh, lq, lk, d):
    """dq-bias and dkv-bias against their plain versions. Rows whose every key
    is masked get a zero cotangent, as in the model: no real row attends to a
    pad key (p = 0 exactly) and no loss reads a pad row."""
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, d)
    bias = _bias(cuda_device, kind, b, h, lq, lk)
    g = torch.Generator(cuda_device).manual_seed(5)
    out = flash_attention(q, k, v, bias=bias)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    if kind == "mask":
        live = (bias > torch.finfo(torch.float32).min).any(-1, keepdim=True)
        dout = dout * live
    delta = attention_delta(out, dout)
    before = (attention_bwd_dq.launches, attention_bwd_dkv.launches,
              attention_bwd_dq.bias_launches, attention_bwd_dkv.bias_launches)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta, bias)
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches,
            attention_bwd_dq.bias_launches, attention_bwd_dkv.bias_launches) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    want_dq, want_lse = attention_bwd_dq_reference(q, k, v, dout, delta, bias)
    want_dk, want_dv = attention_bwd_dkv_reference(q, k, v, dout, want_lse, delta, bias)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert_grad_close(got, want)


@pytest.mark.parametrize("kind", ["mask", "head"])
def test_biased_backward_repeats_bit_for_bit(cuda_device, kind):
    """Two identical calls of dq-bias and dkv-bias give the same bits, with a
    bias broadcast over the heads (the model's mask: the grid runs the heads
    fastest) and with a per-head bias (the tiles fastest)."""
    b, h, l = 3, 8, 387
    q, k, v = _qkv(cuda_device, b, h, h, l, l, 128)
    bias = _bias(cuda_device, kind, b, h, l, l)
    out = flash_attention(q, k, v, bias=bias)
    g = torch.Generator(cuda_device).manual_seed(9)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    delta = attention_delta(out, dout)
    first = attention_bwd_dq(q, k, v, dout, delta, bias)
    grads = attention_bwd_dkv(q, k, v, dout, first[1], delta, bias)
    again = attention_bwd_dq(q, k, v, dout, delta, bias)
    for a, b_ in zip((*first, *grads), (*again, *attention_bwd_dkv(q, k, v, dout, again[1],
                                                                   delta, bias))):
        assert torch.equal(a, b_)


def test_biased_backward_copies_a_bias_no_map_describes(cuda_device):
    """A per-head bias at L 387 held contiguously (rows 1,548 bytes apart: no
    tensor map describes it) is copied once by each of dq-bias and dkv-bias
    (`.bias_copies`) and gives the bits its padded view (`aligned_rows`)
    gives, which is read in place."""
    from mmada_tpu_torch.ops.tensor_maps import aligned_rows

    b, h, l = 2, 4, 387
    q, k, v = _qkv(cuda_device, b, h, h, l, l, 128)
    bias = _bias(cuda_device, "head", b, h, l, l)
    padded = aligned_rows(bias)
    out = flash_attention(q, k, v, bias=padded)
    g = torch.Generator(cuda_device).manual_seed(10)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    delta = attention_delta(out, dout)

    def copies():
        return attention_bwd_dq.bias_copies, attention_bwd_dkv.bias_copies

    before = copies()
    want_dq, want_lse = attention_bwd_dq(q, k, v, dout, delta, padded)
    want = attention_bwd_dkv(q, k, v, dout, want_lse, delta, padded)
    assert copies() == before
    dq, lse = attention_bwd_dq(q, k, v, dout, delta, bias)
    got = attention_bwd_dkv(q, k, v, dout, lse, delta, bias)
    assert copies() == (before[0] + 1, before[1] + 1)
    for a, b_ in zip((dq, lse, *got), (want_dq, want_lse, *want)):
        assert torch.equal(a, b_)


def test_biased_backward_dead_rows_match_plain_versions(cuda_device):
    """Rows whose every key is masked, with a nonzero cotangent: dq-bias gives
    them the finite min as lse (p = 1/Lk on each key) and dkv-bias p = 1 on
    each key, as the plain versions do; the gradients match them."""
    b, h, l = 2, 4, 387
    q, k, v = _qkv(cuda_device, b, h, h, l, l, 128)
    bias, _ = _mask_bias(cuda_device, b, l, 40)
    dead = (bias <= torch.finfo(torch.float32).min).all(-1).expand(b, h, l)
    assert dead.any()
    out = flash_attention(q, k, v, bias=bias)
    g = torch.Generator(cuda_device).manual_seed(11)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta, bias)
    want_dq, want_lse = attention_bwd_dq_reference(q, k, v, dout, delta, bias)
    want_dk, want_dv = attention_bwd_dkv_reference(q, k, v, dout, want_lse, delta, bias)
    assert bool((lse[dead] == torch.finfo(torch.float32).min).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert_grad_close(got, want)


def test_biased_backward_is_finite_on_fully_masked_rows(cuda_device):
    """With a nonzero cotangent on the rows that have no allowed key, dq, dk
    and dv stay finite (dkv's p is 1 on such a row: its lse is the finite
    min)."""
    q, k, v = _qkv(cuda_device, 2, 4, 4, 387, 387, 128)
    bias, mask = _mask_bias(cuda_device, 2, 387, 40)
    g = torch.Generator(cuda_device).manual_seed(6)
    out = flash_attention(q, k, v, bias=bias)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, bias=bias)
    for t in (out, dq, dk, dv):
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("rope", [True, False])
def test_biased_attention_is_differentiable_on_cuda(cuda_device, rope):
    """`bidirectional_attention` with a mask bias on the card: gradients
    through B2 and B3-bias equal the CPU path's (the plain versions), pad rows
    with a zero cotangent, and no gradient reaches the bias."""
    b, h, l, d = 2, 4, 300, 128
    q, k, v = _qkv(cuda_device, b, h, 2, l, l, d)
    bias, mask = _mask_bias(cuda_device, b, l, 30)
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(l, d, 500000.0, device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(3)
    dout = torch.randn(b, h, l, d, generator=g, device=cuda_device).bfloat16()
    dout = dout * mask[:, None, :, None].bfloat16()

    def grads(device):
        ins = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        bias_in = bias.to(device).requires_grad_()
        tables = [None if t is None else t.to(device) for t in (sin, cos)]
        out = bidirectional_attention(*ins, bias=bias_in, rope_sin=tables[0],
                                      rope_cos=tables[1])
        *gs, gb = torch.autograd.grad(out, ins + [bias_in], dout.to(device),
                                      allow_unused=True)
        assert gb is None
        return gs

    before = (attention_bwd_dq.bias_launches, attention_bwd_dkv.bias_launches)
    got = grads(cuda_device)
    assert (attention_bwd_dq.bias_launches, attention_bwd_dkv.bias_launches) == (
        before[0] + 1, before[1] + 1)
    for a, b_ in zip(got, grads("cpu")):
        assert_grad_close(a.cpu(), b_)


def _tiny_special():
    vocab = tiny_layout()
    t = vocab.text_vocab_size
    return vocab, SpecialIds(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16,
                             t2m=t - 15, som=t - 14, eom=t - 13, pad=vocab.pad_token_id,
                             bos=vocab.bos_token_id, eos=vocab.eos_token_id)


def test_masked_paths_go_through_the_biased_kernels(cuda_device):
    """A 2-layer bf16 model with attention masks on: t2i serving runs B2
    once per layer per step and no B1; a train step with t2i_masks runs B2
    twice per layer (forward + recompute) and dq-bias / dkv-bias once per
    layer, and none of the unbiased kernels; B2 reads the model's bias (odd
    frame lengths) without a copy."""
    import numpy as np

    vocab, sp = _tiny_special()
    cfg = dataclasses.replace(
        llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2),
        attention_bias_enabled=True)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0),
                            policy=BF16, remat="full")
    kernels = (flash_attention, attention_bwd_dq, attention_bwd_dkv)

    def counts():
        return tuple(getattr(f, a) for f in kernels for a in ("launches", "bias_launches"))

    c0, copies = counts(), flash_attention.bias_copies
    codes = serve_t2i(model, ["a cat", "a much longer dog"], special_ids=sp, num_vq_tokens=16,
                      max_text_len=8, timesteps=4, guidance_scale=2.0)
    n = cfg.n_layers
    assert tuple(c - b for c, b in zip(counts(), c0)) == (0, 4 * n, 0, 0, 0, 0)
    assert codes.shape == (2, 16)
    rng = np.random.default_rng(0)
    flows = {"t2i_flow": {"input_ids": ["a cat", "a dog with a long caption"],
                          "image_codes": rng.integers(0, 64, (2, 100))},
             "lm_flow": {"input_ids": ["hello there", "general"]},
             "mmu_flow": {"input_ids": ["what?", "who?"], "image_codes": rng.integers(0, 64, (2, 100))}}
    c0 = counts()
    trainer = train(model, [flows], steps=1, special_ids=sp, max_text_len=16,
                    training=dict(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2,
                                  loss_chunk=64),
                    lr_scheduler={"scheduler": "constant", "params": {"learning_rate": 1e-3}})
    assert tuple(c - b for c, b in zip(counts(), c0)) == (0, 2 * n, 0, n, 0, n)
    h = trainer.history[0]
    assert all(np.isfinite(v) for v in h.values()) and h["skipped_nonfinite"] == 0
    assert flash_attention.bias_copies == copies   # the model's bias needs no copy


def test_model_logits_do_not_depend_on_reduced_precision_reductions(cuda_device):
    """ROADMAP C.6, settled: torch lets cuBLAS reduce bf16 products in
    reduced precision by default (`allow_bf16_reduced_precision_reduction`),
    where the JAX reference's dots accumulate in fp32. At the 8B's widths
    (d_model 4096, MLP 12288, the 134,656-token head; 2 layers, random bf16
    weights) and the t2i CFG frame (4 x 1,155) the model's logits are the
    same bits inside and outside `exact_bf16_reductions()`: cuBLAS takes no
    reduced-precision reduction at these shapes, so the model's path sets
    nothing."""
    from mmada_tpu_torch.core.vocab import MMADA_8B

    cfg = dataclasses.replace(llada.llada_8b(), n_layers=2)
    model = MMadaModel.init(cfg, MMADA_8B, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0), policy=BF16)
    ids = torch.randint(0, MMADA_8B.total_vocab_size, (4, 1155),
                        generator=torch.Generator().manual_seed(1)).to(cuda_device)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    allowed = model.forward(ids)
    with exact_bf16_reductions():
        exact = model.forward(ids)
    assert torch.isfinite(allowed).all()
    torch.testing.assert_close(allowed, exact, atol=0, rtol=0)


def test_fp32_model_on_the_card_matches_the_cpu(cuda_device):
    """A tiny model under the FP32 policy, built on the card from the CPU's
    weights: its logits within 1e-5 of the CPU's, through B7 (never the
    wgmma kernels), with TF32 off in its products whatever the caller's
    flags (`policy_products`); the same weights in bf16 on the card still
    take B1."""
    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=128, n_heads=2)
    params = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, vocab.total_vocab_size, (2, 150),
                        generator=torch.Generator().manual_seed(1))
    want = MMadaModel(cfg=cfg, params=params, vocab=vocab, policy=FP32).forward(ids)
    assert MMadaModel.init(cfg, vocab, device=cuda_device, policy=FP32).policy == FP32
    card = MMadaModel(cfg=cfg, vocab=vocab, policy=FP32, params={
        k: t.to(cuda_device) if torch.is_tensor(t) else {n: w.to(cuda_device)
                                                          for n, w in t.items()}
        for k, t in params.items()})
    before = (flash_attention.launches, flash_attention.generic_launches)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = card.forward(ids.to(cuda_device)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    assert (flash_attention.launches, flash_attention.generic_launches) == (
        before[0], before[1] + cfg.n_layers)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    bf16 = dataclasses.replace(card, params=llada.init_params(
        cfg, device=cuda_device, dtype=torch.bfloat16), policy=BF16)
    bf16.forward(ids.to(cuda_device))
    assert flash_attention.launches == before[0] + cfg.n_layers


def _generic_qkv(device, dtype, b, h, kvh, lq, lk, d, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(b, h, lq, d, generator=g, device=device) * 3
    k = torch.randn(b, kvh, lk, d, generator=g, device=device)
    v = torch.randn(b, kvh, lk, d, generator=g, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _assert_generic_grad_close(got, want):
    """B8 against its plain version: fp32 within 1e-5 of the gradient's
    largest entry (the sums' order only); bf16 at the wgmma kernels' bar."""
    if got.dtype == torch.bfloat16:
        assert_grad_close(got, want)
    else:
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# (dtype, B, H, KVH, Lq, Lk, D, rope, bias): fp32 at every width, bf16 at the
# widths the wgmma kernels do not take; GQA, RoPE, rectangular, biased
GENERIC_CASES = [
    (torch.float32, 2, 4, 2, 200, 200, 16, True, None),
    (torch.float32, 1, 4, 4, 130, 77, 96, False, "head"),
    (torch.float32, 2, 4, 4, 387, 387, 64, True, "mask"),
    (torch.float32, 1, 4, 1, 300, 300, 128, True, None),
    (torch.float32, 1, 2, 2, 129, 129, 256, True, "head"),
    (torch.float32, 1, 2, 2, 65, 65, 512, False, None),
    (torch.bfloat16, 2, 4, 2, 200, 200, 96, True, "mask"),
    (torch.bfloat16, 1, 2, 1, 384, 384, 256, False, "head"),
    (torch.bfloat16, 1, 2, 2, 129, 129, 512, True, None),
    (torch.bfloat16, 1, 4, 4, 63, 127, 16, False, None),
    # B7's wgmma body at the zero-filled widths (instances 64, 128, 256) and
    # its ffma body at a width that is no multiple of 64
    (torch.bfloat16, 1, 4, 2, 200, 200, 48, True, "mask"),
    (torch.bfloat16, 1, 4, 4, 387, 387, 192, True, "head"),
    (torch.bfloat16, 1, 4, 4, 100, 300, 240, False, None),
    (torch.float32, 1, 4, 2, 300, 300, 208, True, None),
]


def _generic_bias(device, kind, b, h, lq, lk):
    g = torch.Generator(device).manual_seed(9)
    if kind == "head":
        return torch.randn(b, h, lq, lk, generator=g, device=device) * 2
    if kind == "mask":
        keep = torch.ones(b, lk, dtype=torch.long, device=device)
        keep[:, :11] = 0
        return llada.prepare_attention_bias(keep)
    return None


@pytest.mark.parametrize("dtype,b,h,kvh,lq,lk,d,rope,bias", GENERIC_CASES)
def test_generic_kernels_match_plain_versions(cuda_device, dtype, b, h, kvh, lq, lk, d, rope,
                                              bias):
    """B7 (RoPE by its C entry's rotation pass), then B8-dq and B8-dkv as a
    pair (B8-dq's lse into B8-dkv), against the plain versions; counted in
    `.generic_launches` / `.generic_bias_launches` and B8's in the counter
    of the body `generic_body(..., backward=True)` names, never in the wgmma
    counters. fp32
    forward within 1e-5 absolute."""
    from mmada_tpu_torch.ops.attention import apply_rope

    q, k, v = _generic_qkv(cuda_device, dtype, b, h, kvh, lq, lk, d)
    bias = _generic_bias(cuda_device, bias, b, h, lq, lk)
    attr = "generic_launches" if bias is None else "generic_bias_launches"
    sin = cos = None
    if rope:
        sin, cos = llada.rope_sin_cos(lq, d, 500000.0, device=cuda_device)
    wgmma = (flash_attention.launches, flash_attention.bias_launches, attention_bwd_dq.launches,
             attention_bwd_dkv.launches)
    before = tuple(getattr(f, attr) for f in (flash_attention, attention_bwd_dq,
                                              attention_bwd_dkv))
    bodies = _b8_bodies(attention_bwd_dq, attention_bwd_dkv)
    got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    want = flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        assert_b1_close(got, want)
    qr, kr = apply_rope(q, k, sin, cos) if rope else (q, k)
    g = torch.Generator(cuda_device).manual_seed(5)
    dout = torch.randn(want.shape, generator=g, device=cuda_device).to(dtype)
    if bias is not None:   # no cotangent on rows without an allowed key, as in the model
        dout = dout * (bias > torch.finfo(torch.float32).min).any(-1, keepdim=True)
    delta = attention_delta(want, dout)
    dq, lse = attention_bwd_dq(qr, kr, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv(qr, kr, v, dout, lse, delta, bias)
    want_dq, want_lse = attention_bwd_dq_reference(qr, kr, v, dout, delta, bias)
    want_dk, want_dv = attention_bwd_dkv_reference(qr, kr, v, dout, want_lse, delta, bias)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for a, w, t in ((dq, want_dq, q), (dk, want_dk, k), (dv, want_dv, v)):
        assert a.dtype == dtype and a.shape == t.shape
        _assert_generic_grad_close(a, w)
    assert tuple(getattr(f, attr) for f in (flash_attention, attention_bwd_dq,
                                            attention_bwd_dkv)) == tuple(x + 1 for x in before)
    assert (flash_attention.launches, flash_attention.bias_launches, attention_bwd_dq.launches,
            attention_bwd_dkv.launches) == wgmma
    assert _b8_bodies(attention_bwd_dq, attention_bwd_dkv) == _moved(
        bodies, generic_body(dtype, d, backward=True))


def _b8_bodies(dq_fn, dkv_fn) -> tuple:
    """The body counters of a pair of B8 wrappers: (wgmma, ffma) of dq, then of dkv."""
    return tuple(getattr(f, f"{b}_body_launches") for f in (dq_fn, dkv_fn)
                 for b in ("wgmma", "ffma"))


def _moved(counts: tuple, body: str) -> tuple:
    """`_b8_bodies`' counts after one launch of dq and of dkv through `body`."""
    i = 0 if body == "wgmma" else 1
    return tuple(c + (j % 2 == i) for j, c in enumerate(counts))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 256),
                                     (torch.float32, 16), (torch.bfloat16, 48),
                                     (torch.bfloat16, 96), (torch.bfloat16, 192)])
def test_generic_long_kernels_match_plain_versions(cuda_device, dtype, d):
    """B7-long and B8-dq-long / B8-dkv (the long tier's functions: p in fp32,
    divided last) against their plain versions at 4,224 tokens, GQA."""
    q, k, v = _generic_qkv(cuda_device, dtype, 1, 4, 2, 4224, 4224, d)
    before = (flash_attention_long.launches, attention_bwd_dq_long.launches)
    g0 = (flash_attention_long.generic_launches, attention_bwd_dq_long.generic_launches,
          attention_bwd_dkv_long.generic_launches)
    bodies = _b8_bodies(attention_bwd_dq_long, attention_bwd_dkv_long)
    got = flash_attention_long(q, k, v)
    want = flash_attention_long_reference(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2 ** -14, rtol=2 ** -7)
    dout = torch.randn(want.shape, generator=torch.Generator(cuda_device).manual_seed(3),
                       device=cuda_device).to(dtype)
    got = flash_attention_bwd_long(q, k, v, want, dout)
    ref = flash_attention_bwd_long_reference(q, k, v, want, dout)
    for a, w in zip(got, ref):
        if dtype == torch.float32:
            _assert_generic_grad_close(a, w)
        else:
            assert float((a.float() - w.float()).norm() / w.float().norm()) <= 1e-3
    assert (flash_attention_long.launches, attention_bwd_dq_long.launches) == before
    assert (flash_attention_long.generic_launches, attention_bwd_dq_long.generic_launches,
            attention_bwd_dkv_long.generic_launches) == tuple(x + 1 for x in g0)
    assert _b8_bodies(attention_bwd_dq_long, attention_bwd_dkv_long) == _moved(
        bodies, generic_body(dtype, d, backward=True))


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("d", [16, 48, 96, 192, 240, 256])
def test_b8_wgmma_body_matches_plain_versions(cuda_device, d, long):
    """B8's wgmma body at the zero-filled widths (B3's / B5's kernels at the
    instances of 64 and 128, attention_wide_bwd.cu at 256), biased, GQA:
    one-pass with a mask that shuts rows out (their cotangent zero) at a
    ragged length, B3's bar; long with a per-head bias, within 1e-3 rel L2
    and 2^-7 of the largest entry (phase 3's long-tier bar). Only the wgmma
    body's counters move."""
    l = 256 if long else 200
    q, k, v = _generic_qkv(cuda_device, torch.bfloat16, 1, 4, 2, l, l, d, seed=d + long)
    bias = _generic_bias(cuda_device, "head" if long else "mask", 1, 4, l, l)
    dout = torch.randn((1, 4, l, d), generator=torch.Generator(cuda_device).manual_seed(6),
                       device=cuda_device).to(torch.bfloat16)
    if not long:
        dout = dout * (bias > torch.finfo(torch.float32).min).any(-1, keepdim=True)
    fns = ((attention_bwd_dq_long, attention_bwd_dkv_long, attention_bwd_dq_long_reference,
            attention_bwd_dkv_long_reference, flash_attention_long_reference) if long else
           (attention_bwd_dq, attention_bwd_dkv, attention_bwd_dq_reference,
            attention_bwd_dkv_reference, flash_attention_reference))
    dq_fn, dkv_fn, dq_ref, dkv_ref, fwd_ref = fns
    delta = attention_delta(fwd_ref(q, k, v, bias=bias), dout)
    bodies = _b8_bodies(dq_fn, dkv_fn)
    dq, lse = dq_fn(q, k, v, dout, delta, bias)
    dk, dv = dkv_fn(q, k, v, dout, lse, delta, bias)
    assert _b8_bodies(dq_fn, dkv_fn) == _moved(bodies, "wgmma")
    want_dq, want_lse = dq_ref(q, k, v, dout, delta, bias)
    want_dk, want_dv = dkv_ref(q, k, v, dout, want_lse, delta, bias)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    for a, w, t in ((dq, want_dq, q), (dk, want_dk, k), (dv, want_dv, v)):
        assert a.dtype == torch.bfloat16 and a.shape == t.shape
        if long:
            a, w = a.float(), w.float()
            assert torch.isfinite(a).all()
            assert float((a - w).norm() / w.norm()) <= 1e-3
            assert float((a - w).abs().max()) <= 2 ** -7 * float(w.abs().max())
        else:
            assert_grad_close(a, w)


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 16), (torch.bfloat16, 48), (torch.bfloat16, 96), (torch.bfloat16, 192),
    (torch.bfloat16, 256), (torch.bfloat16, 512), (torch.float32, 16), (torch.float32, 128),
    (torch.float32, 256), (torch.float32, 512)])
def test_b7_bodies_match_plain_versions(cuda_device, dtype, d, long):
    """B7's forward through the body `generic_body` names (its counter
    moves, the other body's does not), against the plain version: one-pass
    with RoPE and a mask that shuts rows out, long with a per-head bias.
    fp32 within 1e-5 absolute; bf16 at B1's bar (one-pass) or within one
    bf16 ulp (long)."""
    l = 256 if long else 200
    q, k, v = _generic_qkv(cuda_device, dtype, 1, 4, 2, l, l, d, seed=d)
    wrapper = flash_attention_long if long else flash_attention
    body = generic_body(dtype, d)
    other = "ffma" if body == "wgmma" else "wgmma"
    before = (getattr(wrapper, f"{body}_body_launches"), getattr(wrapper, f"{other}_body_launches"))
    if long:
        bias = _generic_bias(cuda_device, "head", 1, 4, l, l)
        got = flash_attention_long(q, k, v, bias)
        want = flash_attention_long_reference(q, k, v, bias)
    else:
        bias = _generic_bias(cuda_device, "mask", 1, 4, l, l)
        sin, cos = llada.rope_sin_cos(l, d, 500000.0, device=cuda_device)
        got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
        want = flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    assert (getattr(wrapper, f"{body}_body_launches"),
            getattr(wrapper, f"{other}_body_launches")) == (before[0] + 1, before[1])
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    elif long:
        torch.testing.assert_close(got.float(), want.float(), atol=2 ** -14, rtol=2 ** -7)
    else:
        assert_b1_close(got, want)


def test_kernel_for_routes_on_the_card(cuda_device):
    """bf16 at D 128 launches B1 and never B7; fp32 at D 128 and bf16 at D 96
    launch B7 and never B1; fp16 and D 8 raise before any launch."""
    counters = (flash_attention.launches, flash_attention.generic_launches)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 128)
    flash_attention(q, k, v)
    assert (flash_attention.launches, flash_attention.generic_launches) == (
        counters[0] + 1, counters[1])
    flash_attention(q.float(), k.float(), v.float())
    flash_attention(q[..., :96], k[..., :96], v[..., :96])
    assert (flash_attention.launches, flash_attention.generic_launches) == (
        counters[0] + 1, counters[1] + 2)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="no attention kernel"):
        flash_attention(q[..., :8], k[..., :8], v[..., :8])
    assert (flash_attention.launches, flash_attention.generic_launches) == (
        counters[0] + 1, counters[1] + 2)


@pytest.mark.parametrize("m,k,n", [(477, 4096, 4096), (4620, 4096, 12288), (17, 12288, 4096),
                                   (1, 128, 256), (200, 256, 384)])
def test_int4_f32_kernel_matches_plain_version(cuda_device, m, k, n):
    """B6-f32 (fp32 x) against x @ the fp32 dequantisation: within 1e-5 of
    the output's largest entry; fp32 out; counted in `.f32_launches`."""
    packed, scales = _int4_weight(cuda_device, (k, n), seed=m + n)
    x = torch.randn((m, k), generator=torch.Generator(cuda_device).manual_seed(k),
                    device=cuda_device)
    before = (int4_matmul.launches, int4_matmul.f32_launches)
    got = int4_matmul(x, packed, scales)
    assert (int4_matmul.launches, int4_matmul.f32_launches) == (before[0], before[1] + 1)
    want = int4_matmul_reference(x, packed, scales)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_launches_run_on_the_tensors_device(cuda_device):
    """Each launch runs with q's device current and restores the caller's
    current device afterwards; a launch on cuda:0 is counted."""
    dev0 = torch.device("cuda", 0)
    q, k, v = _qkv(dev0, 1, 2, 2, 64, 64, 128)
    bias = torch.zeros(1, 1, 64, 64, device=dev0)
    current = torch.cuda.current_device()
    before = (flash_attention.launches, flash_attention.bias_launches,
              attention_bwd_dq.bias_launches, attention_bwd_dkv.bias_launches)
    out = flash_attention(q, k, v)
    out_b = flash_attention(q, k, v, bias=bias)
    flash_attention_bwd(q, k, v, out_b, out_b, bias=bias)
    assert torch.cuda.current_device() == current
    assert (flash_attention.launches, flash_attention.bias_launches,
            attention_bwd_dq.bias_launches, attention_bwd_dkv.bias_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1)
    assert_b1_close(out_b, out)


# ------------------------------------------------------------------- long

# The long tier keeps p in fp32 and enters it into the tensor cores as two
# bf16 halves (about 16 significant bits, a relative error of at most 2^-18
# per term against the plain version's fp32 products). So a bf16 output is
# within one bf16 ulp of the plain version's, plus an absolute 2^-14 where
# cancellation leaves an entry small (four times the 2^-18 x max|v| the
# split can add at these inputs); gradients within 1e-3 normwise.
LONG_ABS_FLOOR = 2.0 ** -14
LONG_GRAD_REL_L2 = 1e-3


def assert_within_one_ulp(got, want):
    got, want = got.detach().float(), want.detach().float()
    assert torch.isfinite(got).all()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), exp - 8)   # bf16: 8 significant bits
    excess = (got - want).abs() - ulp
    assert float(excess.max()) <= LONG_ABS_FLOOR, float(excess.max())


def assert_long_grad_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    rel = float((got - want).norm()) / max(float(want.norm()), 1e-30)
    assert rel <= LONG_GRAD_REL_L2, rel


@pytest.mark.parametrize("kind,b,h,kvh,lq,lk,d", [
    (None, 1, 4, 4, 4224, 4224, 128),      # just past the one-pass range
    (None, 1, 8, 2, 1024, 1024, 64),       # GQA, head_dim 64
    (None, 2, 4, 4, 256, 640, 128),        # rectangular
    (None, 1, 8, 2, 4224, 4224, 128),      # GQA 4:1, an odd number of query tiles
    (None, 1, 8, 2, 8192, 8192, 128),      # the served long frame, GQA
    (None, 1, 4, 1, 4224, 4224, 64),       # one kv head, head_dim 64
    ("mask", 2, 4, 4, 4224, 4224, 128),    # padded frames, rows fully masked
    ("head", 1, 4, 4, 512, 512, 128),      # per-head float bias
    ("batch", 2, 8, 2, 768, 768, 64),
    ("one", 2, 4, 4, 384, 384, 128),
    ("head-only", 2, 4, 4, 256, 256, 128),
])
def test_long_kernel_matches_plain_version(cuda_device, kind, b, h, kvh, lq, lk, d):
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, d)
    bias = None if kind is None else _bias(cuda_device, kind, b, h, lq, lk)
    attr = "launches" if bias is None else "bias_launches"
    before = getattr(flash_attention_long, attr)
    got = flash_attention_long(q, k, v, bias)
    assert getattr(flash_attention_long, attr) == before + 1
    want = flash_attention_long_reference(q, k, v, bias)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_within_one_ulp(got, want)


@pytest.mark.parametrize("kind,b,h,kvh,lq,lk,d", [
    (None, 1, 4, 4, 4224, 4224, 128),
    (None, 1, 4, 2, 4224, 4352, 128),      # GQA and rectangular, as the JAX test
    (None, 1, 8, 2, 512, 512, 64),         # GQA, head_dim 64
    (None, 1, 8, 2, 4224, 4352, 64),       # GQA 8:2, rectangular, head_dim 64
    (None, 2, 4, 1, 4352, 4224, 128),      # one kv head, Lq > Lk, a batch of two
    ("mask", 2, 4, 4, 4224, 4224, 128),    # padded frames, zero cotangent there
    ("head", 1, 4, 4, 512, 512, 128),
    ("one", 2, 4, 4, 256, 384, 128),       # rectangular, one bias for all
])
def test_long_backward_kernels_match_plain_versions(cuda_device, kind, b, h, kvh, lq, lk,
                                                    d):
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, d)
    bias = None if kind is None else _bias(cuda_device, kind, b, h, lq, lk)
    g = torch.Generator(cuda_device).manual_seed(5)
    out = flash_attention_long(q, k, v, bias)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    if kind == "mask":
        dout = dout * (bias > torch.finfo(torch.float32).min).any(-1, keepdim=True)
    delta = attention_delta(out, dout)
    attr = "launches" if bias is None else "bias_launches"
    before = (getattr(attention_bwd_dq_long, attr), getattr(attention_bwd_dkv_long, attr))
    dq, lse = attention_bwd_dq_long(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv_long(q, k, v, dout, lse, delta, bias)
    assert (getattr(attention_bwd_dq_long, attr), getattr(attention_bwd_dkv_long, attr)) == (
        before[0] + 1, before[1] + 1)
    want_dq, want_lse = attention_bwd_dq_long_reference(q, k, v, dout, delta, bias)
    want_dk, want_dv = attention_bwd_dkv_long_reference(q, k, v, dout, want_lse, delta, bias)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16
        assert_long_grad_close(got, want)
    if kind == "mask":  # a cotangent on the rows with no allowed key: finite
        dout_all = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
        for t in flash_attention_bwd_long(q, k, v, out, dout_all, bias):
            assert torch.isfinite(t).all()


def test_long_backward_reads_views_through_tensor_maps(cuda_device):
    """The unbiased B5-dq and B5-dkv read q, k, v and dO through tensor maps:
    head views of (B, L, H*D) projections and of a GQA (B, L, KVH*D) one are
    read in place and give what contiguous copies give, bit for bit; an
    operand no map describes (a 2-byte offset) is copied first, with the
    same result; lse and delta at an unaligned base are copied too."""
    b, l, h, kvh, d = 1, 4224, 4, 2, 128
    g = torch.Generator(cuda_device).manual_seed(2)
    fused_q = torch.randn(b, l, 2 * h * d, generator=g, device=cuda_device).bfloat16()
    q, dout = (t.view(b, l, h, d).transpose(1, 2) for t in fused_q.split(h * d, dim=-1))
    fused_kv = torch.randn(b, l, 2 * kvh * d, generator=g, device=cuda_device).bfloat16()
    k, v = (t.view(b, l, kvh, d).transpose(1, 2) for t in fused_kv.split(kvh * d, dim=-1))
    out = flash_attention_long(q, k, v)
    delta = attention_delta(out, dout)
    dense = [t.contiguous() for t in (q, k, v, dout)]
    before = (attention_bwd_dq_long.launches, attention_bwd_dkv_long.launches)
    dq, lse = attention_bwd_dq_long(q, k, v, dout, delta)
    dk, dv = attention_bwd_dkv_long(q, k, v, dout, lse, delta)
    want_dq, want_lse = attention_bwd_dq_long(*dense, delta)
    want = attention_bwd_dkv_long(*dense, want_lse, delta)
    assert (attention_bwd_dq_long.launches, attention_bwd_dkv_long.launches) == (
        before[0] + 2, before[1] + 2)
    torch.testing.assert_close(dq, want_dq, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    torch.testing.assert_close((dk, dv), want, atol=0, rtol=0)
    wide = torch.randn(b, h, l, d + 8, generator=g, device=cuda_device).bfloat16()
    wide[..., 1:d + 1] = dout
    odd = wide[..., 1:d + 1]   # 2 bytes off: no tensor map describes it
    torch.testing.assert_close(attention_bwd_dq_long(q, k, v, odd, delta), (dq, lse),
                               atol=0, rtol=0)
    stats = torch.empty(2 * lse.numel() + 1, device=cuda_device)
    lse_odd = stats[1:lse.numel() + 1].view_as(lse).copy_(lse)     # 4 bytes off
    delta_odd = stats[lse.numel() + 1:].view_as(delta).copy_(delta)
    torch.testing.assert_close(attention_bwd_dkv_long(q, k, v, odd, lse_odd, delta_odd),
                               (dk, dv), atol=0, rtol=0)


@pytest.mark.parametrize("kind,h,kvh,d", [("mask", 4, 4, 128), ("batch", 4, 2, 64)])
def test_biased_long_forward_grid_orders_agree(cuda_device, kind, h, kvh, d):
    """B4-bias runs a bias broadcast over the heads with the heads fastest in
    the grid and a per-head bias with the tiles fastest: the broadcast bias
    and its per-head copy give the same bits (each block computes the same
    tile either way), within one bf16 ulp of the plain version, and a
    second identical call gives the same bits again (the bias tile, read from
    shared memory with ordinary loads, is fenced before its slot's next TMA
    load)."""
    b, l = 2, 1024
    q, k, v = _qkv(cuda_device, b, h, kvh, l, l, d)
    bias = _bias(cuda_device, kind, b, h, l, l)
    per_head = bias.expand(b, h, l, l).contiguous()
    runs = [flash_attention_long(q, k, v, t) for t in (bias, per_head, bias)]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    torch.testing.assert_close(runs[0], runs[2], atol=0, rtol=0)
    assert_within_one_ulp(runs[0], flash_attention_long_reference(q, k, v, bias))


def test_biased_long_forward_dead_rows_average_v(cuda_device):
    """B4-bias on query rows that the mask shuts out entirely (every score
    the finite min): each of the Lk keys gets p = 1, so the row averages v
    (as the plain version and the TPU tiers on aligned L), without NaN; the
    other rows stay within one bf16 ulp of the plain version."""
    b, h, l = 2, 4, 4224
    q, k, v = _qkv(cuda_device, b, h, 2, l, l, 128)
    bias, mask = _mask_bias(cuda_device, b, l, 70)
    out = flash_attention_long(q, k, v, bias)
    mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(2, dim=1).expand(b, h, l, 128)
    dead = (mask == 0)[:, None, :, None].expand(b, h, l, 128)
    assert dead.any()
    assert_within_one_ulp(out.float()[dead], mean[dead])
    assert_within_one_ulp(out, flash_attention_long_reference(q, k, v, bias))


def test_biased_long_backward_keeps_its_kernel(cuda_device):
    """With a bias, B5-dq and B5-dkv launch their biased kernels (the wgmma
    bodies with the bias tile): `.bias_launches` moves and `.launches`, the
    counter of the unbiased ones, does not."""
    b, h, l, d = 1, 2, 256, 128
    q, k, v = _qkv(cuda_device, b, h, h, l, l, d)
    bias = _bias(cuda_device, "head", b, h, l, l)
    out = flash_attention_long(q, k, v, bias)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(6),
                       device=cuda_device).bfloat16()
    before = [(f.launches, f.bias_launches) for f in (attention_bwd_dq_long,
                                                      attention_bwd_dkv_long)]
    dq, dk, dv = flash_attention_bwd_long(q, k, v, out, dout, bias)
    after = [(f.launches, f.bias_launches) for f in (attention_bwd_dq_long,
                                                     attention_bwd_dkv_long)]
    assert after == [(n, nb + 1) for n, nb in before]
    want = flash_attention_bwd_long_reference(q, k, v, out, dout, bias)
    for got, w in zip((dq, dk, dv), want):
        assert_long_grad_close(got, w)


@pytest.mark.parametrize("kind,h,kvh,d", [("mask", 4, 4, 128), ("batch", 4, 2, 128),
                                          ("one", 2, 2, 64)])
def test_biased_long_backward_grid_orders_agree(cuda_device, kind, h, kvh, d):
    """B5-dq-bias and B5-dkv-bias run a bias broadcast over the heads with
    the heads fastest in the grid, and a per-head bias with the tiles
    fastest. The broadcast bias and its per-head copy give the same bits
    (each block computes the same tile either way), and both meet the plain
    versions' bars, GQA and head_dim 64 too."""
    b, l = 2, 1024
    q, k, v = _qkv(cuda_device, b, h, kvh, l, l, d)
    bias = _bias(cuda_device, kind, b, h, l, l)
    out = flash_attention_long(q, k, v, bias)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(7),
                       device=cuda_device).bfloat16()
    if kind == "mask":
        dout = dout * (bias > torch.finfo(torch.float32).min).any(-1, keepdim=True)
    per_head = bias.expand(b, h, l, l).contiguous()
    runs = [flash_attention_bwd_long(q, k, v, out, dout, t) for t in (bias, per_head)]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    for got, want in zip(runs[0], flash_attention_bwd_long_reference(q, k, v, out, dout, bias)):
        assert_long_grad_close(got, want)


def test_long_kernels_take_strided_views(cuda_device):
    """Head views of (B, L, H*D) projections, a dO head view and an expanded
    bias view (0 strides) give what contiguous copies give, bit for bit."""
    b, l, h, d = 1, 4224, 2, 128
    g = torch.Generator(cuda_device).manual_seed(1)
    fused = torch.randn(b, l, 3 * h * d, generator=g, device=cuda_device).bfloat16()
    q, k, v = (t.view(b, l, h, d).transpose(1, 2) for t in fused.split(h * d, dim=-1))
    row = torch.randn(1, 1, l, l, generator=g, device=cuda_device)
    view = row.expand(b, h, l, l)
    got = flash_attention_long(q, k, v, view)
    want = flash_attention_long(q.contiguous(), k.contiguous(), v.contiguous(), row)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    dout = torch.randn(b, l, h * d, generator=g, device=cuda_device).bfloat16()
    dout = dout.view(b, l, h, d).transpose(1, 2)
    got = flash_attention_bwd_long(q, k, v, want, dout, view)
    want = flash_attention_bwd_long(q.contiguous(), k.contiguous(), v.contiguous(), want,
                                     dout.contiguous(), row)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_long_attention_is_differentiable_on_cuda(cuda_device, masked):
    """`bidirectional_attention` at an aligned L past 4096 with RoPE: B4 and
    B5 on the card give the CPU path's output and gradients (the plain
    versions), with a mask bias too (pad rows with a zero cotangent)."""
    b, h, l, d = 1, 2, 4224, 128
    q, k, v = _qkv(cuda_device, b, h, 1, l, l, d)
    bias, mask = _mask_bias(cuda_device, b, l, 70) if masked else (None, None)
    sin, cos = llada.rope_sin_cos(l, d, 500000.0, device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(3)
    dout = torch.randn(b, h, l, d, generator=g, device=cuda_device).bfloat16()
    if masked:
        dout = dout * mask[:, None, :, None].bfloat16()

    def run(device):
        ins = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = bidirectional_attention(*ins, bias=None if bias is None else bias.to(device),
                                      rope_sin=sin.to(device), rope_cos=cos.to(device))
        return out, torch.autograd.grad(out, ins, dout.to(device))

    attr = "launches" if bias is None else "bias_launches"
    kernels = (flash_attention_long, attention_bwd_dq_long, attention_bwd_dkv_long)
    before = [getattr(f, attr) for f in kernels]
    out, grads = run(cuda_device)
    assert [getattr(f, attr) - c for f, c in zip(kernels, before)] == [1, 1, 1]
    want_out, want_grads = run("cpu")
    assert_within_one_ulp(out.cpu(), want_out)
    for a, w in zip(grads, want_grads):
        assert_long_grad_close(a.cpu(), w)


@pytest.mark.parametrize("masked", [False, True])
def test_long_frames_go_through_the_long_kernels(cuda_device, masked):
    """A 2-layer bf16 model with head_dim 128 on frames of 4,224 tokens:
    serving runs B4 once per layer per step; a train step with full remat
    runs B4 twice per layer and B5-dq / B5-dkv once per layer (the biased
    kernels with masks on), and no one-pass kernel."""
    import numpy as np

    vocab, sp = _tiny_special()
    cfg = dataclasses.replace(
        llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2),
        attention_bias_enabled=masked)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0),
                            policy=BF16, remat="full")
    attr = "bias_launches" if masked else "launches"
    one_pass = (flash_attention, attention_bwd_dq, attention_bwd_dkv)
    long = (flash_attention_long, attention_bwd_dq_long, attention_bwd_dkv_long)

    def counts():
        return (tuple(f.launches + f.bias_launches for f in one_pass),
                tuple(getattr(f, attr) for f in long))

    n = cfg.n_layers
    if not masked:  # text frames carry no mask
        (c1, c0) = counts()
        answers = serve_text(model, ["x" * (4224 - 1 - 16)], gen_length=16, steps=2,
                             block_length=16)
        assert answers[0].shape == (16,)
        assert counts() == (c1, (c0[0] + 2 * n, c0[1], c0[2]))
    n_img = 100
    rng = np.random.default_rng(0)
    flows = {"t2i_flow": {"input_ids": ["a cat", "a dog with a long caption"],
                          "image_codes": rng.integers(0, 64, (2, n_img))},
             "lm_flow": {"input_ids": ["hello there", "general"]}}
    (c1, c0) = counts()
    copiers = (flash_attention, flash_attention_long, attention_bwd_dq_long,
               attention_bwd_dkv_long)
    copies = [f.bias_copies for f in copiers]
    trainer = train(model, [flows], steps=1, special_ids=sp, max_text_len=4224 - n_img - 3,
                    training=dict(batch_size_t2i=2, batch_size_lm=2, loss_chunk=64),
                    lr_scheduler={"scheduler": "constant", "params": {"learning_rate": 1e-3}})
    frames = trainer.prepare_batch(flows)
    assert {t.shape[1] for key, t in frames.items() if key.endswith("input_ids")} == {4224}
    assert counts() == (c1, (c0[0] + 2 * n, c0[1] + n, c0[2] + n))
    assert [f.bias_copies for f in copiers] == copies
    h = trainer.history[0]
    assert all(np.isfinite(v) for v in h.values()) and h["skipped_nonfinite"] == 0


# --------------------------------------------------------------------- int4

# B6's dequantised bf16 weight is bit for bit the plain version's, and both
# accumulate in fp32: only the order of the sums differs, so each bf16 output
# is within one bf16 ulp of the plain version's, plus 2^-14 where
# cancellation leaves an entry small. The plain version's bf16 matmul is
# held to full fp32 reductions for the comparison.
INT4_ABS_FLOOR = 2.0 ** -14


@pytest.fixture
def cuda_fp32_reductions(cuda_device):
    with exact_bf16_reductions():
        yield cuda_device


def _int4_weight(device, shape, seed):
    g = torch.Generator(device).manual_seed(seed)
    return pack_int4(torch.randn(shape, generator=g, device=device) * 0.02)


def _int4_x(device, m, k, seed):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn((m, k), generator=g, device=device).bfloat16()


def assert_int4_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    excess = (got - want).abs() - torch.ldexp(torch.ones_like(got), exp - 8)
    assert float(excess.max()) <= INT4_ABS_FLOOR


@pytest.mark.parametrize("m,k,n", [
    (477, 4096, 4096), (477, 4096, 12288), (477, 12288, 4096), (96, 4096, 134656),
    (4620, 4096, 12288), (16, 4096, 134656), (1, 4096, 4096), (17, 4096, 4096),
    (130, 4096, 4096), (200, 128, 256),
])
def test_int4_kernel_matches_plain_version(cuda_fp32_reductions, m, k, n):
    device = cuda_fp32_reductions
    packed, scales = _int4_weight(device, (k, n), seed=m + n)
    x = _int4_x(device, m, k, seed=k)
    before = int4_matmul.launches
    got = int4_matmul(x, packed, scales)
    assert int4_matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert_int4_close(got, int4_matmul_reference(x, packed, scales))
    assert torch.equal(int4_matmul(x, packed, scales), got)   # a repeated call: the same bits


@pytest.mark.parametrize("m,k,n,rows", [(128, 128, 256, 128), (4096, 4096, 8192, 256)])
def test_int4_expanded_tile_is_read_as_wgmma_reads_it(cuda_device, m, k, n, rows):
    """x the identity, so out = W: the weight B6 expands into shared memory,
    as its wgmma products read it (the 128-byte swizzle of an MN-major B
    operand), is bit for bit the plain version's dequantised W, at both tile
    heights. An expansion written in another layout than the descriptor
    reads runs and gives wrong numbers."""
    from mmada_tpu_torch.ops.int4_matmul import block_rows, unpack_int4

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert block_rows(m, n, sms) == rows
    packed, scales = _int4_weight(cuda_device, (k, n), seed=12)
    x = torch.eye(m, k, device=cuda_device, dtype=torch.bfloat16)
    got = int4_matmul(x, packed, scales)
    torch.testing.assert_close(got, unpack_int4(packed, scales, torch.bfloat16)[:m], atol=0,
                               rtol=0)


def test_int4_map_cache_holds_a_bounded_number_of_shapes(cuda_device, monkeypatch):
    """A server meets a new M with each frame length: B6's maps are kept
    for at most _MAPS_HELD shapes, the oldest dropped first, and a shape
    described again gives the same bits."""
    from mmada_tpu_torch.ops import int4_matmul as int4_mod

    monkeypatch.setattr(int4_mod, "_MAPS_HELD", 4)
    monkeypatch.setattr(int4_mod, "_maps", {})
    packed, scales = _int4_weight(cuda_device, (128, 128), seed=5)
    x = _int4_x(cuda_device, 8, 128, seed=6)
    first = int4_matmul(x[:1], packed, scales)
    for m in range(2, 8):
        int4_matmul(x[:m], packed, scales)
    assert sorted(key[0] for key in int4_mod._maps) == [4, 5, 6, 7]
    assert torch.equal(int4_matmul(x[:1], packed, scales), first)


def test_int4_kernel_reads_windows_and_layers_in_place(cuda_fp32_reductions):
    """The t2i head's column window of a 134,656-wide packed head, and one
    layer of a stacked weight, as strided views (no copy); and x with
    leading dims."""
    device = cuda_fp32_reductions
    packed, scales = _int4_weight(device, (4096, 134656), seed=1)
    x = _int4_x(device, 4096, 4096, seed=2).view(4, 1024, 4096)
    win_p, win_s = packed[:, 126464:134656], scales[:, 126464:134656]
    assert not win_p.is_contiguous()
    got = int4_matmul(x, win_p, win_s)
    assert got.shape == (4, 1024, 8192)
    assert_int4_close(got, int4_matmul_reference(x, win_p, win_s))
    stacked_p, stacked_s = _int4_weight(device, (3, 4096, 4096), seed=3)
    x = _int4_x(device, 300, 4096, seed=4)
    assert_int4_close(int4_matmul(x, stacked_p[1], stacked_s[1]),
                      int4_matmul_reference(x, stacked_p[1], stacked_s[1]))


def test_int4_kernel_refuses_what_it_cannot_take(cuda_device):
    packed, scales = _int4_weight(cuda_device, (256, 256), seed=7)
    x = _int4_x(cuda_device, 8, 256, seed=8)
    small_p, small_s = _int4_weight(cuda_device, (64, 128), seed=9)   # per-channel
    before = int4_matmul.launches
    for call, err in (
            (lambda: int4_matmul(x.half(), packed, scales), TypeError),       # fp16 x
            (lambda: int4_matmul(x[:, :128], packed, scales), ValueError),     # K vs packed
            (lambda: int4_matmul(x[:, :64], small_p, small_s), ValueError),    # K % 128
            (lambda: int4_matmul(x, packed[:, :192], scales[:, :192]), ValueError),  # N % 128
            (lambda: int4_matmul(x, packed, scales[:1]), ValueError),          # scale rows
            (lambda: int4_matmul(x, packed.cpu(), scales), ValueError),        # devices
            (lambda: int4_matmul(x, packed, scales.double()), TypeError)):
        with pytest.raises(err):
            call()
    assert int4_matmul.launches == before


def test_int4_served_requests_launch_b6_per_matmul(cuda_device):
    """A 2-layer int4 model (head_dim 128, vocab a 128 multiple) on the card:
    every text forward launches B6 once per block matmul and once for the
    head (7 x 2 + 1); a t2i forward once per block matmul, its head window
    (the 64 image ids of the tiny vocab, not a 128 multiple) taking x @ the
    dequantised weight, the JAX package's rule."""
    vocab, sp = _tiny_special()
    cfg = llada.tiny_config(vocab_size=384, d_model=256, n_heads=2, mlp_hidden_size=512)
    model = quantize(MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                                     generator=torch.Generator(cuda_device).manual_seed(0),
                                     policy=BF16), "int4")
    per_forward = 7 * cfg.n_layers + 1
    before = int4_matmul.launches
    answers = serve_text(model, ["abc", "xyz"], gen_length=16, steps=8, block_length=8)
    assert int4_matmul.launches - before == 8 * per_forward
    assert all((a != vocab.mask_token_id).all() for a in answers)
    before = int4_matmul.launches
    codes = serve_t2i(model, ["a cat", "a dog"], special_ids=sp, num_vq_tokens=16,
                      max_text_len=8, timesteps=4, guidance_scale=2.0)
    assert int4_matmul.launches - before == 4 * (per_forward - 1)
    assert ((codes >= 0) & (codes < vocab.image_codebook_size)).all()


@pytest.mark.parametrize("m,n,window", [(1, 4096, None), (16, 4096, None),
                                        (96, 134656, (126464, 134656)), (40, 1000, None)])
def test_w8a8_int8_product_on_the_card_equals_the_cpu(cuda_device, m, n, window):
    """The int8 x int8 product (`torch._int_mm`, its operands zero-padded
    where the card's call wants it: M > 16, widths multiples of 8) gives the
    CPU's int32 sums and W8A8's output bits, for few rows and a column window
    of a head."""
    g = torch.Generator().manual_seed(m)
    x = torch.randn((m, 4096), generator=g).bfloat16()
    w = Q._quantize_w8a8(torch.randn((4096, n), generator=g) * 0.02)
    w_card = Q.W8A8Tensor(values=w.values.to(cuda_device), scales=w.scales.to(cuda_device))
    if window is not None:   # the windowed views, taken on each device
        w, w_card = (Q.W8A8Tensor(values=t.values[:, window[0]:window[1]],
                                  scales=t.scales[window[0]:window[1]]) for t in (w, w_card))
        assert not w_card.values.is_contiguous()
    x_q, x_scale = Q.quantize_activations(x)
    want = Q.int8_matmul(x_q, w.values)
    got = Q.int8_matmul(x_q.to(cuda_device), w_card.values)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(Q.w8a8_matmul(x.to(cuda_device), w_card).cpu(), Q.w8a8_matmul(x, w))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def assert_codes_meet_the_cpu_bar(z, z_cpu):
    """MAGVIT-v2's latents on the card against the fp32 CPU's: atol 2e-4
    scaled by the largest |latent|, rtol 1e-3 (tests/test_magvit_parity.py);
    a code may differ only through a channel whose CPU latent is within the
    measured latent error of 0."""
    err = (z - z_cpu).abs()
    max_err = float(err.max())
    assert bool((err <= 2e-4 * z_cpu.abs().max() + 1e-3 * z_cpu.abs()).all()), max_err
    flipped = (z > 0) != (z_cpu > 0)
    c = z.shape[-1]
    assert torch.equal(flipped.any(-1).reshape(z.shape[0], -1),
                       magvit2.lfq_indices(z, c) != magvit2.lfq_indices(z_cpu, c))
    assert not bool(flipped.any()) or float(z_cpu.abs()[flipped].max()) <= max_err


@pytest.mark.parametrize("res", [16, 32])
def test_tiny_magvit_on_the_card_meets_the_cpu_bar(cuda_device, res):
    """Encode and decode on the card against the CPU, the same fp32 weights;
    pixels within the decode bar (atol 5e-4 scaled by the largest |pixel|,
    rtol 1e-3)."""
    cfg = magvit2.tiny_vqgan(res)
    vq = magvit2.init_magvit2(cfg, device="cpu", generator=torch.Generator().manual_seed(res))
    card = _to(vq, cuda_device)
    pixels = torch.rand((2, 2 * res, res, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    z_cpu = magvit2.encoder_forward(vq["encoder"], cfg, pixels)
    z = magvit2.encoder_forward(card["encoder"], cfg, pixels.to(cuda_device))
    assert z.device.type == "cuda"
    assert_codes_meet_the_cpu_bar(z.cpu(), z_cpu)
    codes = magvit2.lfq_indices(z_cpu, cfg.z_channels)
    want = magvit2.decode_code(vq, cfg, codes, (res, res // 2))
    got = magvit2.decode_code(card, cfg, codes.to(cuda_device), (res, res // 2)).cpu()
    assert bool(((got - want).abs() <= 5e-4 * want.abs().max() + 1e-3 * want.abs()).all())
    square = magvit2.lfq_indices(z_cpu[:, :res // 2], cfg.z_channels)
    images = decode_images(card, cfg, square)
    pixels = magvit2.decode_code(card, cfg, square.to(cuda_device))
    assert images.dtype == torch.uint8 and images.shape == (2, res, res, 3)
    assert torch.equal(images, ((pixels + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu())


def test_flagship_codes_do_not_depend_on_tf32_flags(cuda_device):
    """magvit2_default() on 256-px images: the codes with TF32 at torch's
    defaults (cuDNN on, matmul off) and with TF32 on everywhere equal those
    with TF32 off, bit for bit, and so does a repeat; the caller's flags are
    left as they were."""
    cfg = magvit2.magvit2_default()
    vq = magvit2.init_magvit2(cfg, device=cuda_device,
                              generator=torch.Generator(cuda_device).manual_seed(0))
    pixels = torch.rand((2, 256, 256, 3), generator=torch.Generator(cuda_device).manual_seed(1),
                        device=cuda_device) * 2 - 1
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        runs = []
        for cudnn_tf32, matmul_tf32 in ((False, False), (True, False), (True, True),
                                        (False, False)):
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
            runs.append(magvit2.get_code(vq, cfg, pixels))
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (cudnn_tf32, matmul_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert runs[0].shape == (2, 256)
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.parametrize("fast", [False, True])
def test_mmu_requests_launch_b1_only(cuda_device, fast):
    """`serve_mmu` on a small bf16 model and a tiny MAGVIT-v2 on the card:
    B1 once a layer a forward, no other kernel."""
    vocab, sp = _tiny_special()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=128, n_heads=2)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0), policy=BF16)
    vq_cfg = magvit2.tiny_vqgan(16)
    vq = magvit2.init_magvit2(vq_cfg, device=cuda_device,
                              generator=torch.Generator(cuda_device).manual_seed(1))
    pixels = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    kernels = [(fn, attr) for fn in (flash_attention, attention_bwd_dq, attention_bwd_dkv,
                                     flash_attention_long, attention_bwd_dq_long,
                                     attention_bwd_dkv_long)
               for attr in ("launches", "bias_launches")] + [(int4_matmul, "launches")]
    before = [getattr(fn, attr) for fn, attr in kernels]
    answers = serve_mmu(model, vq, vq_cfg, pixels, ["what is it?", "who?"], special_ids=sp,
                        max_new_tokens=16, steps=8, block_length=8, fast=fast)
    launched = [getattr(fn, attr) - b for (fn, attr), b in zip(kernels, before)]
    forwards = launched[0] // cfg.n_layers
    assert launched[0] == cfg.n_layers * forwards and launched[1:] == [0] * (len(kernels) - 1)
    # two frame lengths, two batches; the fast sampler may stop after a block
    assert forwards == 2 * 8 or (fast and 2 * 4 <= forwards < 2 * 8)
    assert [a.shape for a in answers] == [(16,), (16,)]


@pytest.mark.parametrize("b,h,kvh,lq,lk", [
    (3, 32, 32, 32, 159),      # text: 3 requests, a block of 32 over the 159-token frame
    (1, 32, 32, 128, 1194),    # MMU: the block of 128 over the bench's 1,194-token frame
    (4, 32, 32, 1024, 1155),   # t2i: the image span under CFG over span + compact cache
    (1, 32, 32, 64, 8192),     # long text: a block of 64 over 8,192 keys (past 4096)
])
def test_kernel_at_cached_step_shapes(cuda_device, b, h, kvh, lq, lk):
    """B1 at the block-KV decode's step shapes (rectangular, no RoPE): one
    launch through the attention dispatch, no long-tier launch, within B1's
    bars of its plain version."""
    q, k, v = _qkv(cuda_device, b, h, kvh, lq, lk, 128)
    before = (flash_attention.launches, flash_attention_long.launches)
    got = bidirectional_attention(q, k, v)
    assert (flash_attention.launches, flash_attention_long.launches) == (before[0] + 1,
                                                                          before[1])
    assert_b1_close(got, flash_attention_reference(q, k, v))


@pytest.mark.parametrize("cache", [True, "int8"])
def test_kv_step_on_the_card_matches_its_plain_path(cuda_device, cache):
    """A small bf16 model on the card (head_dim 128): a capture launches B1
    once a layer (square, RoPE outside), a step once a layer (rectangular),
    and the step's logits are within the small model's bar (rel L2 5e-2) of
    the same step on the CPU in fp32 (the plain path) and of the exact
    forward's block logits on the card."""
    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0), policy=BF16)
    ids = torch.randint(3, 200, (2, 96), generator=torch.Generator().manual_seed(1))
    start, blk = 64, 16
    cache_dtype = "int8" if cache == "int8" else None
    before = flash_attention.launches
    kv = llada.forward_kv_capture(model.params, cfg, ids.cuda(), policy=BF16,
                                  cache_dtype=cache_dtype)
    assert flash_attention.launches - before == cfg.n_layers
    got = llada.forward_kv_step(model.params, cfg, ids[:, start:start + blk].cuda(), kv, start,
                                policy=BF16).float()
    assert flash_attention.launches - before == 2 * cfg.n_layers
    cpu = {k: (v.float().cpu() if isinstance(v, torch.Tensor) else
               {n: t.float().cpu() for n, t in v.items()}) for k, v in model.params.items()}
    cpu_kv = llada.forward_kv_capture(cpu, cfg, ids, cache_dtype=cache_dtype)
    want = llada.forward_kv_step(cpu, cfg, ids[:, start:start + blk], cpu_kv, start)
    exact = model.forward(ids.cuda(), logit_positions=(start, blk)).float()

    def rel(a, b):
        return float((a.cpu() - b.cpu()).norm() / b.cpu().norm())

    assert torch.isfinite(got).all()
    assert rel(got, want) <= 5e-2, rel(got, want)
    assert rel(got, exact) <= 5e-2, rel(got, exact)


def _small_engine_model(device):
    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2)
    return MMadaModel.init(cfg, vocab, device=device, dtype=torch.bfloat16,
                           generator=torch.Generator(device).manual_seed(0), policy=BF16)


def _solo(model, prompt, seed, **kw):
    g = torch.Generator(model.device).manual_seed(seed) if kw.get("temperature", 0) else None
    return model.generate(torch.as_tensor(prompt, device=model.device)[None], generator=g,
                          **kw)[0].cpu().numpy()


def test_engine_rows_with_their_seeds_on_the_card(cuda_device):
    """Two stochastic requests released together share one batch (B1 once a
    layer a step) and each equals its solo run with its seed."""
    import numpy as np

    from mmada_tpu_torch.serve.engine import ServingEngine, TextSettings

    model = _small_engine_model(cuda_device)
    kw = dict(gen_length=16, steps=8, block_length=8, temperature=1.0)
    eng = ServingEngine(model, min_chunk_device_ms=0, max_wait_ms=1).start()
    try:
        eng.pause()
        before = flash_attention.launches
        futs = [eng.submit_text(np.arange(3, 9), TextSettings(**kw), seed=s) for s in (0, 1)]
        eng.resume()
        outs = [f.result(120) for f in futs]
        assert flash_attention.launches - before == model.cfg.n_layers * 8
        assert eng.stats["batches"] == 1
    finally:
        eng.stop()
    for s, got in zip((0, 1), outs):
        np.testing.assert_array_equal(got, _solo(model, np.arange(3, 9), s, **kw))


def test_stream_join_on_the_card(cuda_device):
    """A chunked request joins a running stream; at T = 0 each answer equals
    its solo monolithic run (the rows of one chunk at different blocks), and
    a segmented run of the first its engine answer, bit for bit."""
    import time

    import numpy as np

    from mmada_tpu_torch.serve.engine import ServingEngine, TextSettings

    model = _small_engine_model(cuda_device)
    kw = dict(gen_length=32, steps=16, block_length=8)
    settings = TextSettings(**kw, segment_steps=1)
    pa, pb = np.arange(3, 9), np.arange(10, 16)
    eng = ServingEngine(model, min_chunk_device_ms=0, max_wait_ms=1).start()
    try:
        fa = eng.submit_text(pa, settings)
        while eng.stats["chunks"] < 2:
            time.sleep(0.001)
        eng.pause()
        fb = eng.submit_text(pb, settings)
        eng.resume()
        ra, rb = fa.result(120), fb.result(120)
        assert eng.stats["stream_joins"] == 1
    finally:
        eng.stop()
    np.testing.assert_array_equal(ra, _solo(model, pa, 0, **kw))
    np.testing.assert_array_equal(rb, _solo(model, pb, 0, **kw))
    seg = model.generate(torch.as_tensor(pa, device=cuda_device)[None], segment_steps=3, **kw)
    np.testing.assert_array_equal(seg[0].cpu().numpy(), ra)


def test_t2i_windows_on_the_card(cuda_device):
    """The segmented t2i run (windows of 2, cut by a guidance interval)
    gives the monolithic codes with the same generator; B1 once a layer a
    step."""
    model = _small_engine_model(cuda_device)
    v = model.vocab
    frame = torch.cat([torch.full((1, 6), 5), torch.full((1, 1), 250),
                       torch.full((1, 16), v.mask_token_id), torch.full((1, 1), 251)], 1)
    uncond = frame.clone()
    uncond[:, :6] = v.pad_token_id
    kw = dict(uncond_input_ids=uncond.to(cuda_device), timesteps=6, guidance_scale=2.0,
              num_vq_tokens=16, cfg_interval=(1 / 6, 5 / 6))

    def run(**extra):
        g = torch.Generator(cuda_device).manual_seed(4)
        return model.t2i_generate(frame.to(cuda_device), generator=g, **kw, **extra)

    want = run()
    before = flash_attention.launches
    got = run(segment_timesteps=2)
    assert flash_attention.launches - before == model.cfg.n_layers * 6
    assert torch.equal(got, want)


# ------------------------------------------------------------ text to motion

# the t2m frame of configs/t2m_instruct.yaml: 64 + 1 text positions,
# <|som|>, 55 motion positions, <|eom|>
T2M_FRAME = 122


@pytest.mark.parametrize("b,h,pad", [(2, 4, 40), (4, 8, 0)])
def test_t2m_frame_kernels_match_plain_versions(cuda_device, b, h, pad):
    """B2 and dq-bias / dkv-bias at the t2m frame (122 tokens: fp32 bias rows
    of 488 bytes, which `prepare_attention_bias` pads so that no kernel
    copies the bias) with the frame's pad mask, against their plain versions
    on the rows with an allowed key."""
    q, k, v = _qkv(cuda_device, b, h, h, T2M_FRAME, T2M_FRAME, 128)
    mask = torch.ones(b, T2M_FRAME, dtype=torch.long, device=cuda_device)
    for row in range(b):
        mask[row, :pad + 3 * row] = 0
    bias = llada.prepare_attention_bias(mask)
    sin, cos = llada.rope_sin_cos(T2M_FRAME, 128, 500000.0, device=cuda_device)
    copies = (flash_attention.bias_copies, attention_bwd_dq.bias_copies,
              attention_bwd_dkv.bias_copies)
    got = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    live = mask.bool()[:, None, :, None]
    want = flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias)
    assert_b1_close(got * live, want * live)
    out = flash_attention(q, k, v, bias=bias)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(3),
                       device=cuda_device).bfloat16() * live
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta, bias)
    want_dq, want_lse = attention_bwd_dq_reference(q, k, v, dout, delta, bias)
    want_dk, want_dv = attention_bwd_dkv_reference(q, k, v, dout, want_lse, delta, bias)
    for g, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert_grad_close(g, w)
    assert (flash_attention.bias_copies, attention_bwd_dq.bias_copies,
            attention_bwd_dkv.bias_copies) == copies


def test_t2m_paths_go_through_the_kernels(cuda_device):
    """A 2-layer bf16 model with the motion vocab: masked exact t2m runs B2
    once a layer a step, the cached t2m B1 (its capture and steps take no
    mask), and a masked t2m train step (full remat) B2 twice a layer and
    dq-bias / dkv-bias once; segmented and engine codes equal the direct
    call's."""
    import numpy as np

    from mmada_tpu_torch.entry import serve_t2m
    from mmada_tpu_torch.serve.engine import ServingEngine, T2MSettings
    from mmada_tpu_torch.training import optimizers, t2m
    from mmada_tpu_torch.training.train_step import TrainState

    vocab, sp = _tiny_special()
    vocab = vocab.with_motion(32)
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2)
    model = MMadaModel.init(cfg, vocab, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(cuda_device).manual_seed(0),
                            policy=BF16, remat="full")
    masked = dataclasses.replace(model, cfg=dataclasses.replace(cfg, attention_bias_enabled=True))
    kernels = (flash_attention, attention_bwd_dq, attention_bwd_dkv)

    def counts():
        return tuple(getattr(f, a) for f in kernels for a in ("launches", "bias_launches"))

    n, steps = cfg.n_layers, 4
    kw = dict(special_ids=sp, num_motion_tokens=16, max_text_len=12, timesteps=steps)
    c0 = counts()
    exact = serve_t2m(masked, ["walk", "a person jumps"], **kw)
    assert tuple(c - b for c, b in zip(counts(), c0)) == (0, steps * n, 0, 0, 0, 0)
    seg = serve_t2m(masked, ["walk", "a person jumps"], segment_timesteps=3, **kw)
    assert torch.equal(seg, exact) and exact.shape == (2, 16)
    c0 = counts()
    serve_t2m(model, ["walk"], block_kv_cache=True, **kw)
    assert tuple(c - b for c, b in zip(counts(), c0)) == ((steps + 1) * n, 0, 0, 0, 0, 0)

    frame = np.concatenate([[sp.pad] * 3, [sp.t2m, 1, 40, 41, 2], [sp.som],
                            [vocab.mask_token_id] * 16, [sp.eom]])
    mask = (frame != sp.pad).astype(np.int64)
    eng = ServingEngine(masked, min_chunk_device_ms=0).start()
    try:
        got = eng.submit_t2m(frame, T2MSettings(timesteps=steps, num_motion_tokens=16,
                                                segment_timesteps=2), seed=3,
                             attention_mask=mask).result(300)
    finally:
        eng.stop()
    want = masked.t2m_generate(torch.as_tensor(frame[None], device=cuda_device),
                               attention_mask=torch.as_tensor(mask[None], device=cuda_device),
                               timesteps=steps, num_motion_tokens=16,
                               generator=torch.Generator(cuda_device).manual_seed(3))
    np.testing.assert_array_equal(got, want[0].cpu().numpy())

    opt = optimizers.AdamW(1e-4)
    state = TrainState.create(masked.params, opt)
    step = t2m.make_t2m_train_step(masked, opt, t2m.T2MStepConfig(
        batch_size=2, max_text_len=8, num_motion_tokens=16))
    ids = torch.as_tensor(np.stack([frame, frame]), device=cuda_device)
    ids[:, 9:-1] = vocab.motion_offset + torch.arange(16, device=cuda_device) % 32
    labels = torch.full_like(ids, -100)
    labels[:, 9:-1] = ids[:, 9:-1]
    c0 = counts()
    state, m = step(state, {"input_ids": ids, "labels": labels,
                            "attention_mask": torch.as_tensor(np.stack([mask, mask]),
                                                              device=cuda_device)},
                    torch.Generator(cuda_device).manual_seed(0))
    assert tuple(c - b for c, b in zip(counts(), c0)) == (0, 2 * n, 0, n, 0, n)
    assert np.isfinite(float(m["loss"])) and float(m["skipped_nonfinite"]) == 0
