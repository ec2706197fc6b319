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
not take: it never falls back. B6 runs on `wgmma` and reads x, the packed
weight and its scales and writes the output through TMA tensor maps, which
the wrapper describes (`tensor_maps.describe_matrix`), with tiles of 128 or
256 rows (`block_rows`). For a CPU tensor it computes
`int4_matmul_reference`, JAX's function in plain PyTorch (dequantise in
fp32, cast to x's dtype, then x @ w), which the CPU tests hold against the
JAX kernel and `chip_smoke.py` holds B6 against on the card. It counts its
launches in `int4_matmul.launches`; a launch runs under
`torch.cuda.device(x.device)` on that device's current stream.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mmada_tpu_torch.ops.tensor_maps import describe_matrix, spec_array

GROUP = 128          # quantization group size along the contracting dim
_PACK = GROUP // 2   # packed byte rows per group
_SOURCE = "int4_matmul"
_BLOCK_COLS = 128    # output columns of a B6 tile
_OUT_BOX = 64        # B6 stores its output 64 x 64 at a time
# a wave's cost beyond its tiles' rows (pipeline fill, epilogue, launch), in
# rows: where one wave holds every tile at either height (477 rows, N 4096,
# K 4096 and 12288) a 256-row wave took 1.34x and 1.35x a 128-row one on an
# H100, i.e. 253 and 237 rows' worth (attention_ab.py --only int4 against
# copies of B6 forced to one height)
_TILE_OVERHEAD_ROWS = 245
_fn = None
_sms: dict = {}
# B6's map descriptions by (M, K, N, row strides, SMs): with the bases
# checked 16-byte aligned they depend on nothing else, and describing four
# maps costs more host time (about 19 us on a CPU core) than B6 takes on the
# card at the text batch's q/k/v shapes (about 46 us). A server meets a new
# M with each frame length, so the oldest of _MAPS_HELD entries goes first.
_MAPS_HELD = 256
_maps: dict = {}


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
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def block_rows(m: int, n: int, sms: int) -> int:
    """B6's tile rows for an (m, n) output on a card of `sms` SMs: 256 where
    its fewer waves take less time than those of 128-row tiles (the
    persistent grid holds one block an SM and walks the tiles in waves of
    `sms`), a wave costing its tiles' rows plus _TILE_OVERHEAD_ROWS."""
    def cost(rows):
        tiles = math.ceil(m / rows) * (n // _BLOCK_COLS)
        return math.ceil(tiles / sms) * (rows + _TILE_OVERHEAD_ROWS)

    return 256 if cost(256) < cost(128) else 128


def int4_maps(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, out: torch.Tensor,
              sms: int) -> list:
    """The tensor maps of B6's operands: x (M, K) in boxes of 64 columns and
    `block_rows` rows, the packed weight in boxes of 128 columns x 64 byte
    rows (one group), the scales 128 x 1, the output 64 x 64."""
    m, n = out.shape
    return [describe_matrix(x, 64, block_rows(m, n, sms)),
            describe_matrix(packed, _BLOCK_COLS, _PACK),
            describe_matrix(scales, _BLOCK_COLS, 1),
            describe_matrix(out, _OUT_BOX, _OUT_BOX)]


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


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
    place through their tensor maps) or its plain version (CPU tensors).
    Counts launches in `int4_matmul.launches`."""
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
        sms = _sm_count(x.device)
        key = (m, k, n, x2.stride(0), packed.stride(0), scales.stride(0), sms)
        maps = _maps.get(key)
        if maps is None:
            if len(_maps) >= _MAPS_HELD:
                _maps.pop(next(iter(_maps)))
            maps = _maps[key] = spec_array(*int4_maps(x2, packed, scales, out, sms))
        with torch.cuda.device(x.device):
            err = _entry()(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
                           m, k, n, maps.buffer_info()[0],
                           torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"int4_matmul kernel launch failed: cudaError {err}")
        int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


int4_matmul.launches = 0
