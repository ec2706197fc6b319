"""Grouped int4 weight matmul: Hopper kernel B6 + its plain version.

Counterpart of `mmada_tpu/ops/int4_matmul.py`: `pack_int4` / `unpack_int4`
(:42-89) and the matmul `int4_matmul` (:113), whose TPU kernel
`_int4_kernel` (:91, called at :149) becomes the CUDA kernel in
`csrc/int4_matmul.cu` (B6).

Layout (the JAX package's, so quantized weights carry over unchanged):
weights are grouped along the contracting dim, GROUP = 128 rows a group, one
fp32 scale per (group, output column), absmax / 7 symmetric; within a group,
packed byte row i (of 64) holds w[i] in bits 0-3 and w[i + 64] in bits 4-7,
both sign-extended. A contracting dim that is not a GROUP multiple packs
per-channel (one group of K rows); such a weight never reaches the kernel
(`quantization.int4_matmul_dispatch` sends it to the dequant route).

`int4_matmul` launches B6 for a CUDA tensor and raises for anything B6 does
not take: it never falls back. For a CPU tensor it computes
`int4_matmul_reference`, JAX's function in plain PyTorch (dequantise in
fp32, cast to x's dtype, then x @ w), which the CPU tests hold against the
JAX kernel and `chip_smoke.py` holds B6 against on the card. It counts its
launches in `int4_matmul.launches`; a launch runs under
`torch.cuda.device(x.device)` on that device's current stream.
"""

from __future__ import annotations

import ctypes

import torch

GROUP = 128          # quantization group size along the contracting dim
_PACK = GROUP // 2   # packed byte rows per group
_SOURCE = "int4_matmul"
_fn = None


def pack_int4(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (..., K, N) -> (packed int8 (..., K/2, N), scales fp32
    (..., K/group, N)): group is GROUP when K divides it (the kernel layout),
    else the whole column (per-channel). K must be even."""
    *lead, k, n = w.shape
    group = GROUP if k % GROUP == 0 else k
    if k % 2:
        raise ValueError(f"contracting dim {k} must be even to pack nibbles")
    wf = w.float().reshape(*lead, k // group, group, n)
    scales = torch.clamp(wf.abs().amax(dim=-2) / 7.0, min=1e-12)   # (..., K/g, N)
    q = torch.clamp(torch.round(wf / scales[..., None, :]), -8, 7).to(torch.int32)
    half = group // 2
    lo, hi = q[..., :half, :], q[..., half:, :]
    packed = ((hi & 0xF) << 4) | (lo & 0xF)                         # byte in [0, 255]
    packed = torch.where(packed > 127, packed - 256, packed).to(torch.int8)
    return packed.reshape(*lead, k // 2, n), scales


def _unpack_i32(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 byte -> (lo, hi) int32 nibbles in [-8, 7]."""
    p32 = p.to(torch.int32)                                          # sign-extends
    return (p32 << 28) >> 28, p32 >> 4                               # arithmetic


def unpack_int4(packed: torch.Tensor, scales: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dequantize back to (..., K, N): nibble x scale in fp32, one cast to
    `dtype`."""
    *lead, half_k, n = packed.shape
    n_groups = scales.shape[-2]
    lo, hi = _unpack_i32(packed.reshape(*lead, n_groups, half_k // n_groups, n))
    w = torch.cat([lo, hi], dim=-2).float() * scales[..., None, :].float()
    return w.reshape(*lead, half_k * 2, n).to(dtype)


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ unpack_int4(packed, scales, x.dtype) -> (..., N) in x's
    dtype (the matmul accumulates in fp32)."""
    return x @ unpack_int4(packed, scales, x.dtype)


def _entry():
    global _fn
    if _fn is None:
        from mmada_tpu_torch.ops import _build

        fn = _build.load_library(_SOURCE).mmada_int4_matmul_bf16
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> tuple[int, int]:
    """(K, N) of operands B6 takes; raises for anything else."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 for the int4 kernel, got {x.dtype} "
                        "(fp32 x is ROADMAP A.17)")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"packed must be int8 and scales float32, got {packed.dtype}, "
                        f"{scales.dtype}")
    for name, t in (("packed", packed), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    k, (half_k, n) = x.shape[-1], packed.shape
    if k != 2 * half_k:
        raise ValueError(f"x K={k} vs packed K/2={half_k}")
    if k % GROUP or n % 128:
        raise ValueError(f"K={k} and N={n} must be multiples of {GROUP} and 128")
    if tuple(scales.shape) != (k // GROUP, n):
        raise ValueError(f"scales {tuple(scales.shape)} are not ({k // GROUP}, {n}): "
                         "the kernel takes 128-row groups only")
    if x.stride(-1) != 1 or packed.stride(-1) != 1 or scales.stride(-1) != 1:
        raise ValueError("x, packed and scales need a contiguous last dim")
    for name, t, align in (("packed", packed, 16), ("scales", scales, 4)):
        if t.stride(0) % align or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned: stride {t.stride()}")
    return k, n


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(packed (K/2, N), scales (K/128, N)) -> (..., N)
    in x's dtype, through B6 (CUDA tensors: bf16 x, K and N multiples of 128,
    128-row groups, 16-byte aligned rows; strided row views are read in
    place) or its plain version (CPU tensors). Counts launches in
    `int4_matmul.launches`."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scales)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    k, n = _check(x, packed, scales)
    x2 = x.reshape(-1, k)
    if x2.stride(0) % 8 or x2.data_ptr() % 16:
        raise ValueError(f"x rows must be 16-byte aligned: stride {x2.stride()}")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            err = _entry()(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
                           m, k, n, x2.stride(0), packed.stride(0), scales.stride(0),
                           torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"int4_matmul kernel launch failed: cudaError {err}")
        int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


int4_matmul.launches = 0
