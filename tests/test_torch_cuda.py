"""Tests of the port that need the card: the Hopper kernel against its plain
version, its refusals, and the served path through it.

They skip without a CUDA device (the kernel has no CPU mode). This file
imports neither jax nor the JAX package, so it also runs beside the card,
where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from mmada_tpu_torch.core.precision import BF16
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import serve_t2i, serve_text
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops.attention import bidirectional_attention
from mmada_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
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


@pytest.mark.parametrize("b,h,kvh,lq,lk,rope,d", [
    (2, 4, 4, 1155, 1155, True, 128),   # unaligned t2i frame
    (1, 8, 2, 200, 200, True, 64),      # GQA, head_dim 64
    (2, 4, 4, 100, 333, False, 128),    # rectangular
    (1, 2, 2, 1, 1, True, 128),         # one token
    (1, 2, 1, 4096, 4096, True, 128),   # the one-pass tier's longest
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
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_kernel_takes_strided_views(cuda_device):
    """q/k/v as head views of (B, L, H*D) projections, as the model passes
    them: no copy, same result as contiguous inputs."""
    b, l, h, d = 2, 300, 4, 128
    g = torch.Generator(cuda_device).manual_seed(1)
    fused = torch.randn(b, l, 3 * h * d, generator=g, device=cuda_device).bfloat16()
    q, k, v = (t.view(b, l, h, d).transpose(1, 2) for t in fused.split(h * d, dim=-1))
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_kernel_refuses_what_it_cannot_take(cuda_device):
    """A CUDA tensor launches the kernel or raises; nothing falls back."""
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 128)
    before = flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :96], k[..., :96], v[..., :96])       # head_dim 96
    with pytest.raises(ValueError):
        flash_attention(q[..., 1:65], k[..., 1:65], v[..., 1:65])    # misaligned
    sin, cos = llada.rope_sin_cos(64, 128, 500000.0, device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :32], v[:, :, :32], rope_sin=sin, rope_cos=cos)
    with pytest.raises(NotImplementedError):
        bidirectional_attention(q, k, v, bias=torch.zeros(1, 1, 64, 64, device=cuda_device))
    long_q = torch.zeros(1, 1, 4097, 128, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(NotImplementedError):
        bidirectional_attention(long_q, long_q, long_q)
    assert flash_attention.launches == before


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
