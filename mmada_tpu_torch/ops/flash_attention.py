"""One-pass bidirectional attention with RoPE: Hopper kernel + plain version.

Counterpart of `flash_attention` in `mmada_tpu/ops/flash_attention.py`
(:510-660, kernel bodies `_attn_kernel` / `_attn_rope_kernel` at :59-92).
`flash_attention` launches the CUDA kernel in `csrc/flash_attention_fwd.cu`
for a CUDA tensor, and raises for anything the kernel does not take; it never
falls back. For a CPU tensor it computes `flash_attention_reference`, the
plain PyTorch version of the same function, which the CPU tests hold against
the JAX kernel and `chip_smoke.py` holds the kernel against on the card.

The function: RoPE (neox rotate-half) on q and k in fp32, cast back to the
input dtype; scores q.k^T in fp32 times 1/sqrt(D); softmax in fp32 with p
normalised BEFORE its cast to the dtype of v; p.v accumulated in fp32; the
output in the dtype of q. GQA maps query head h to kv head h // (H / KVH).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_KERNEL_SOURCE = "flash_attention_fwd"
_HEAD_DIMS = (64, 128)
_fn = None


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Neox rotate-half RoPE in fp32, cast back to x's dtype (`_rope_tile`)."""
    xf = x.float()
    d2 = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1)
    return (xf * cos.float() + rot * sin.float()).to(x.dtype)


def flash_attention_reference(
    q: torch.Tensor,                         # (B, H, Lq, D)
    k: torch.Tensor,                         # (B, KVH, Lk, D)
    v: torch.Tensor,                         # (B, KVH, Lk, D)
    rope_sin: Optional[torch.Tensor] = None,  # (L, D): rotate q and k
    rope_cos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (no padding needed: it works
    on the exact lengths, which is what padding plus the finite-min column
    mask computes)."""
    if rope_sin is not None:
        if q.shape[2] != k.shape[2]:
            raise ValueError("rope requires square attention (Lq == Lk)")
        q, k = _rope(q, rope_sin, rope_cos), _rope(k, rope_sin, rope_cos)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)   # normalise before the cast
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _kernel():
    """The C entry of the built library, with its ctypes signature."""
    global _fn
    if _fn is None:
        from mmada_tpu_torch.ops import _build

        fn = _build.load_library(_KERNEL_SOURCE).mmada_flash_attention_fwd_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be 4-D with a contiguous last dim")
    if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} rows must be 16-byte aligned: strides {t.stride()}")


def flash_attention(
    q: torch.Tensor,                         # (B, H, Lq, D)
    k: torch.Tensor,                         # (B, KVH, Lk, D)
    v: torch.Tensor,                         # (B, KVH, Lk, D)
    rope_sin: Optional[torch.Tensor] = None,  # (L, D) fp32: rotate q and k
    rope_cos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention through the Hopper kernel (CUDA tensors) or its plain version
    (CPU tensors). Any length and alignment; rectangular Lq != Lk only
    without RoPE. Counts its launches in `flash_attention.launches` (one per
    call: with RoPE the C entry runs its rotation kernel and the attention
    kernel together)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, rope_sin, rope_cos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {_HEAD_DIMS}")
    if (rope_sin is None) != (rope_cos is None):
        raise ValueError("pass both rope tables or neither")
    if rope_sin is not None:
        if lq != lk:
            raise ValueError("rope requires square attention (Lq == Lk)")
        for name, t in (("rope_sin", rope_sin), ("rope_cos", rope_cos)):
            if (t.device != q.device or t.dtype != torch.float32
                    or tuple(t.shape) != (lq, d) or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"{name} must be contiguous fp32 ({lq}, {d}) on {q.device}")

    # written as (B, Lq, H, D) so the caller's merge of the heads is a view
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    q_rot = k_rot = None
    if rope_sin is not None:  # scratch for the rotated q and k
        q_rot = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
        k_rot = torch.empty((b, kvh, lk, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        rope_sin.data_ptr() if rope_sin is not None else None,
        rope_cos.data_ptr() if rope_cos is not None else None,
        q_rot.data_ptr() if q_rot is not None else None,
        k_rot.data_ptr() if k_rot is not None else None,
        b, h, kvh, lq, lk, d, strides, 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
