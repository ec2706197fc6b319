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

The backward (`flash_attention_bwd`, counterpart of the JAX function of the
same name, :808-1005) takes q and k already rotated, the saved output and its
cotangent, and runs two kernels of `csrc/flash_attention_bwd.cu`:
`attention_bwd_dq` (dq and the row logsumexp; `_attn_bwd_dq_kernel`) and
`attention_bwd_dkv` (dk and dv summed over the query heads of each kv head;
`_attn_bwd_dkv_kernel`). delta = rowsum(dO * O) is computed here in fp32, as
the JAX wrapper does. Each has a plain version, `*_reference`, that the CPU
takes and the card's checks hold the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_KERNEL_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_HEAD_DIMS = (64, 128)
_fn = None
_bwd_fns: dict = {}


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


def _strides(*ts: torch.Tensor):
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


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
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        rope_sin.data_ptr() if rope_sin is not None else None,
        rope_cos.data_ptr() if rope_cos is not None else None,
        q_rot.data_ptr() if q_rot is not None else None,
        k_rot.data_ptr() if k_rot is not None else None,
        b, h, kvh, lq, lk, d, _strides(q, k, v, out), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# --------------------------------------------------------------------------
# Backward
# --------------------------------------------------------------------------

def _heads_like_q(t: torch.Tensor, h: int) -> torch.Tensor:
    """k or v with each kv head repeated over its query heads, in fp32."""
    rep = h // t.shape[1]
    t = t.float()
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def attention_bwd_dq_reference(
    q: torch.Tensor,      # (B, H, Lq, D), rotated
    k: torch.Tensor,      # (B, KVH, Lk, D), rotated
    v: torch.Tensor,      # (B, KVH, Lk, D)
    dout: torch.Tensor,   # (B, H, Lq, D)
    delta: torch.Tensor,  # (B, H, Lq) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """dq (dtype of q) and the row logsumexp (fp32), in plain PyTorch: the
    function of `_attn_bwd_dq_kernel` (fp32 throughout, p = e / l)."""
    h = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    kf = _heads_like_q(k, h)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = e / l
    dp = torch.matmul(dout.float(), _heads_like_q(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    return dq.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor,    # (B, H, Lq) fp32
    delta: torch.Tensor,  # (B, H, Lq) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """dk and dv (dtype of k), in plain PyTorch: the function of
    `_attn_bwd_dkv_kernel` (p = exp(s - lse)); under GQA each kv head sums
    its query heads in fp32 before the cast."""
    b, h, _, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    s = torch.matmul(q.float(), _heads_like_q(k, h).transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, _heads_like_q(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dk = dk.view(b, kvh, h // kvh, lk, d).sum(dim=2)
    dv = dv.view(b, kvh, h // kvh, lk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_kernel(name: str):
    fn = _bwd_fns.get(name)
    if fn is None:
        from mmada_tpu_torch.ops import _build

        fn = getattr(_build.load_library(_BWD_SOURCE), f"mmada_flash_attention_bwd_{name}_bf16")
        p, i = ctypes.c_void_p, ctypes.c_int
        n_ptr = 7 if name == "dq" else 8
        fn.argtypes = [*([p] * n_ptr), i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _bwd_fns[name] = fn
    return fn


def _check_bwd_shapes(q, k, v, dout, stats) -> tuple[int, int, int, int, int, int]:
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_operand(name, t, q.device)
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or dout.shape != q.shape or k.shape[0] != b
            or k.shape[3] != d or h % kvh):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} dout {tuple(dout.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {_HEAD_DIMS}")
    for name, t in stats:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, h, lq) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 ({b}, {h}, {lq}) on {q.device}")
    return b, h, kvh, lq, lk, d


def attention_bwd_dq(q, k, v, dout, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dq, lse) through the Hopper dq kernel (CUDA tensors) or its plain
    version (CPU tensors). Counts launches in `attention_bwd_dq.launches`."""
    if q.device.type == "cpu":
        return attention_bwd_dq_reference(q, k, v, dout, delta)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dq runs on cuda or cpu, not {q.device}")
    b, h, kvh, lq, lk, d = _check_bwd_shapes(q, k, v, dout, [("delta", delta)])
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    err = _bwd_kernel("dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), lse.data_ptr(), b, h, kvh, lq, lk, d,
        _strides(q, k, v, dout, dq), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "attention_bwd_dq")
    attention_bwd_dq.launches += 1
    return dq, lse


attention_bwd_dq.launches = 0


def attention_bwd_dkv(q, k, v, dout, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) through the Hopper dkv kernel (CUDA tensors) or its plain
    version (CPU tensors). Counts launches in `attention_bwd_dkv.launches`."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_reference(q, k, v, dout, lse, delta)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dkv runs on cuda or cpu, not {q.device}")
    b, h, kvh, lq, lk, d = _check_bwd_shapes(
        q, k, v, dout, [("lse", lse), ("delta", delta)])
    dk = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    err = _bwd_kernel("dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, lq, lk, d,
        _strides(q, k, v, dout, dk, dv), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "attention_bwd_dkv")
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, contiguous (B, H, Lq)."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def flash_attention_bwd(
    q: torch.Tensor,     # (B, H, Lq, D), rotated
    k: torch.Tensor,     # (B, KVH, Lk, D), rotated
    v: torch.Tensor,
    out: torch.Tensor,   # the forward's output
    dout: torch.Tensor,  # its cotangent
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): delta, then the dq kernel (which also gives the row
    logsumexp), then the dkv kernel; plain versions for CPU tensors."""
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta)
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, out, dout):
    """`flash_attention_bwd` through the plain versions, on any device."""
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq_reference(q, k, v, dout, delta)
    dk, dv = attention_bwd_dkv_reference(q, k, v, dout, lse, delta)
    return dq, dk, dv
