"""One-pass bidirectional attention with RoPE: Hopper kernels + plain versions.

Counterpart of `flash_attention` in `mmada_tpu/ops/flash_attention.py`
(:510-697): without a bias (kernel bodies `_attn_kernel` / `_attn_rope_kernel`
at :59-92, called at :650) and with one (`_attn_bias_kernel` /
`_attn_rope_bias_kernel` at :148-178, called at :686). `flash_attention`
launches the CUDA kernel in `csrc/flash_attention_fwd.cu` for a CUDA tensor
(B1, or B2 with a bias), and raises for anything the kernel does not take; it
never falls back. B1 and B2 run on `wgmma` and read their operands through
TMA tensor maps, which the wrapper describes (`tensor_maps.py`); an operand
that a map cannot describe is copied first (a bias so copied is counted in
`flash_attention.bias_copies`: the model's biases need none). For a CPU tensor it computes
`flash_attention_reference`, the plain PyTorch version of the same function,
which the CPU tests hold against the JAX kernel and `chip_smoke.py` holds the
kernel against on the card.

The function: RoPE (neox rotate-half) on q and k in fp32, cast back to the
input dtype; scores q.k^T in fp32 times 1/sqrt(D), plus the fp32 bias (B|1,
H|1, Lq, Lk) if there is one; softmax in fp32 with p normalised BEFORE its
cast to the dtype of v; p.v accumulated in fp32; the output in the dtype of
q. GQA maps query head h to kv head h // (H / KVH). A bool bias marks the
allowed pairs and becomes 0 / the finite fp32 min (`bias_as_float`).

A query row whose every key is masked (the padding rows of a masked frame)
has every score at the finite min: the kernels and the plain versions
average v over its Lk keys, as the XLA tier does. The JAX Pallas tier pads K
to the 128 tile and averages over the padded tile too, so it differs from
both on those rows only; no caller reads them.

The backward (`flash_attention_bwd`, counterpart of the JAX function of the
same name, :808-1005) takes q and k already rotated, the saved output and its
cotangent, and runs two kernels of the library built from
`csrc/flash_attention_bwd.cu`: `attention_bwd_dq` (dq and the row
logsumexp; `_attn_bwd_dq_kernel` / `_attn_bwd_dq_bias_kernel`) and
`attention_bwd_dkv` (dk and dv summed over the query heads of each kv head;
`_attn_bwd_dkv_kernel` / `_attn_bwd_dkv_bias_kernel`). Unbiased (B3) they
run on `wgmma` (the bodies of the long tier's B5, in
`csrc/flash_attention_bwd_wgmma.cuh`) and read their operands through
tensor maps (an operand a map cannot describe is copied first), lse and
delta in spans of 64 rows (`tensor_maps.describe_rows`). Biased (B3-bias)
they keep `mma.sync` bodies that take 16-byte aligned rows. delta =
rowsum(dO * O) is computed here in fp32, as the JAX wrapper does. Each has a
plain version, `*_reference`, that the CPU takes and the card's checks hold
the kernel against.

Each wrapper counts its launches: `<wrapper>.launches` for the unbiased
kernel, `<wrapper>.bias_launches` for the biased one. A launch runs under
`torch.cuda.device(q.device)`, on that device's current stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mmada_tpu_torch.ops.tensor_maps import (
    OUT_ROWS,
    STEP_ROWS,
    TILE_ROWS,
    bias_operand,
    describe,
    describe_bias,
    describe_rows,
    rows_operand,
    spec_array,
    tma_operand,
)

_KERNEL_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_HEAD_DIMS = (64, 128)
NEG_F32 = float(torch.finfo(torch.float32).min)
_fns: dict = {}


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Neox rotate-half RoPE in fp32, cast back to x's dtype (`_rope_tile`)."""
    xf = x.float()
    d2 = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1)
    return (xf * cos.float() + rot * sin.float()).to(x.dtype)


def bias_as_float(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An additive fp32 bias: a bool bias (True = allowed) becomes 0 / the
    finite fp32 min, as the JAX kernel wrapper converts it."""
    if bias is None:
        return None
    if bias.dtype == torch.bool:
        return torch.where(bias, 0.0, NEG_F32).float()
    return bias.float()


def _scores(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 q.k^T * scale (+ bias); k already repeated over the query heads."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / (q.shape[-1] ** 0.5))
    return s if bias is None else s + bias_as_float(bias)


def flash_attention_reference(
    q: torch.Tensor,                         # (B, H, Lq, D)
    k: torch.Tensor,                         # (B, KVH, Lk, D)
    v: torch.Tensor,                         # (B, KVH, Lk, D)
    rope_sin: Optional[torch.Tensor] = None,  # (L, D): rotate q and k
    rope_cos: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,     # (B|1, H|1, Lq, Lk) fp32 or bool
) -> torch.Tensor:
    """The kernels' function in plain PyTorch. It works on the exact
    lengths, which is what padding plus the finite-min column mask computes
    on every row with an allowed key; on a row whose every key is masked it
    averages v over the Lk keys, as the XLA tier (`xla_attention`) does."""
    if rope_sin is not None:
        if q.shape[2] != k.shape[2]:
            raise ValueError("rope requires square attention (Lq == Lk)")
        q, k = _rope(q, rope_sin, rope_cos), _rope(k, rope_sin, rope_cos)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = _scores(q, k, bias)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)   # normalise before the cast
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _entry(source: str, name: str, n_ptr: int, arrays: int = 0):
    """The C entry `name` of the library built from `csrc/<source>.cu`, with
    its ctypes signature: `n_ptr` pointers, B, H, KVH, Lq, Lk, D, the
    element strides (a ctypes array, `_strides`) or else `arrays` addresses
    of long long arrays (`tensor_maps.spec_array`), the scale and the
    stream."""
    fn = _fns.get(name)
    if fn is None:
        from mmada_tpu_torch.ops import _build

        fn = getattr(_build.load_library(source), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        lists = [p] * arrays if arrays else [ctypes.POINTER(ctypes.c_longlong)]
        fn.argtypes = [*([p] * n_ptr), i, i, i, i, i, i, *lists, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   aligned: bool = True) -> None:
    """Device, dtype and rank; with `aligned` (B3-bias's cp.async kernels)
    also a contiguous last dim and 16-byte aligned rows. The TMA kernels (B1,
    B2, B3, B4, B5) take any layout: `tensor_maps.tma_operand` copies what a
    map cannot describe."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D")
    if not aligned:
        return
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dim")
    if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} rows must be 16-byte aligned: strides {t.stride()}")


def _check_bias(bias: torch.Tensor, b: int, h: int, lq: int, lk: int,
                device: torch.device) -> None:
    """Device, dtype and shape of the fp32 bias (B|1, H|1, Lq, Lk)."""
    if bias.device != device:
        raise ValueError(f"bias is on {bias.device}, q on {device}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32 for the CUDA kernel, got {bias.dtype}")
    if (bias.dim() != 4 or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)
            or tuple(bias.shape[2:]) != (lq, lk)):
        raise ValueError(f"bias {tuple(bias.shape)} is not (B|1, H|1, Lq, Lk) for "
                         f"B {b}, H {h}, Lq {lq}, Lk {lk}")


def _bias_strides(bias: torch.Tensor, b: int, h: int, lq: int, lk: int,
                  device: torch.device) -> list[int]:
    """Element strides (batch, head, row) of the fp32 bias the cp.async
    kernels (B3-bias) read, 0 on a broadcast axis."""
    _check_bias(bias, b, h, lq, lk, device)
    if lk > 1 and bias.stride(-1) != 1:
        raise ValueError("bias must have a contiguous last dim")
    return [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(3)]


def _strides(*ts: torch.Tensor, extra=()):
    flat = [s for t in ts for s in t.stride()[:3]] + list(extra)
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(fn, device: torch.device, *args) -> None:
    """Run the C entry `fn` with the stream of `device` appended, with
    `device` the current CUDA device, and raise on a launch error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError {err}")


def _bias_map_operand(wrapper, bias: torch.Tensor, b: int, h: int, lq: int, lk: int,
                      device: torch.device) -> torch.Tensor:
    """The bias as a TMA kernel reads it: checked, and copied once if no map
    can describe it (`tensor_maps.bias_operand`), counted in
    `wrapper.bias_copies`."""
    _check_bias(bias, b, h, lq, lk, device)
    bias, copied = bias_operand(bias)
    wrapper.bias_copies += copied
    return bias


def _count_launch(wrapper, bias: Optional[torch.Tensor]) -> None:
    """One launch of `wrapper`'s kernel: `.launches`, or `.bias_launches`
    for its biased kernel."""
    if bias is None:
        wrapper.launches += 1
    else:
        wrapper.bias_launches += 1


def flash_attention(
    q: torch.Tensor,                         # (B, H, Lq, D)
    k: torch.Tensor,                         # (B, KVH, Lk, D)
    v: torch.Tensor,                         # (B, KVH, Lk, D)
    rope_sin: Optional[torch.Tensor] = None,  # (L, D) fp32: rotate q and k
    rope_cos: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,     # (B|1, H|1, Lq, Lk) fp32 or bool
) -> torch.Tensor:
    """Attention through the Hopper kernel (CUDA tensors) or its plain version
    (CPU tensors). Any length and alignment; rectangular Lq != Lk only
    without RoPE. Counts its launches in `flash_attention.launches` (B1) or
    `flash_attention.bias_launches` (B2, with a bias): one per call, since
    with RoPE the C entry runs its rotation kernel and the attention kernel
    together. B1 and B2 read their operands through TMA tensor maps
    (`tensor_maps`), so an operand that a map cannot describe is copied
    first (a bias: `flash_attention.bias_copies`).

    B2 adds the bias in log2 units, saturated at the finite min, so on the
    card every bias at or below -FLT_MAX / log2 e (about -2.36e38) counts as
    the mask's -FLT_MAX: a row whose every key lies there averages v over
    its Lk keys, where the plain version weights only the largest of those
    biases. A mask (0 or the finite min, as `bias_as_float` makes it) and
    any bias above that threshold give the plain version's function."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, rope_sin, rope_cos, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device, aligned=False)
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
    bias = bias_as_float(bias)
    if bias is not None:
        bias = _bias_map_operand(flash_attention, bias, b, h, lq, lk, q.device)
    q, k, v = (tma_operand(t) for t in (q, k, v))

    # written as (B, Lq, H, D) so the caller's merge of the heads is a view
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    q_rot = k_rot = None
    if rope_sin is not None:  # scratch for the rotated q and k
        q_rot = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
        k_rot = torch.empty((b, kvh, lk, d), dtype=q.dtype, device=q.device)
    rope_ptrs = [None if t is None else t.data_ptr() for t in (rope_sin, rope_cos, q_rot, k_rot)]
    scale = 1.0 / (d ** 0.5)
    # one array: the element strides of q and k (the rotation reads them),
    # then the tensor maps of what the attention kernel reads: B1 takes K
    # and V in tiles of 128 keys, B2 in tiles of 64 beside its bias tiles
    kv_rows = TILE_ROWS if bias is None else STEP_ROWS
    maps = [describe(q if q_rot is None else q_rot, TILE_ROWS),
            describe(k if k_rot is None else k_rot, kv_rows), describe(v, kv_rows),
            describe(out, OUT_ROWS)]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if bias is None:
        name = "mmada_flash_attention_fwd_bf16"
    else:
        name = "mmada_flash_attention_fwd_bias_bf16"
        maps.append(describe_bias(bias, TILE_ROWS))
        ptrs.append(bias.data_ptr())
    qs, ks = q.stride(), k.stride()
    args = spec_array(*maps, head=(*qs[:3], *ks[:3]))
    addr = args.buffer_info()[0]
    fn = _entry(_KERNEL_SOURCE, name, len(ptrs) + 4, arrays=2)
    _launch(fn, q.device, *ptrs, *rope_ptrs, b, h, kvh, lq, lk, d, addr,
            addr + 6 * args.itemsize, scale)
    _count_launch(flash_attention, bias)
    return out


flash_attention.launches = 0
flash_attention.bias_launches = 0
flash_attention.bias_copies = 0


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
    bias: Optional[torch.Tensor] = None,  # (B|1, H|1, Lq, Lk)
) -> tuple[torch.Tensor, torch.Tensor]:
    """dq (dtype of q) and the row logsumexp (fp32), in plain PyTorch: the
    function of `_attn_bwd_dq_kernel` / `_attn_bwd_dq_bias_kernel` (fp32
    throughout, p = e / l). On a row whose every key is masked, p = 1/Lk and
    the lse is the finite fp32 min."""
    h = q.shape[1]
    kf = _heads_like_q(k, h)
    s = _scores(q, kf, bias)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = e / l
    dp = torch.matmul(dout.float(), _heads_like_q(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * (1.0 / (q.shape[-1] ** 0.5))
    return dq.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor,    # (B, H, Lq) fp32
    delta: torch.Tensor,  # (B, H, Lq) fp32
    bias: Optional[torch.Tensor] = None,  # (B|1, H|1, Lq, Lk)
) -> tuple[torch.Tensor, torch.Tensor]:
    """dk and dv (dtype of k), in plain PyTorch: the function of
    `_attn_bwd_dkv_kernel` / `_attn_bwd_dkv_bias_kernel` (p = exp(s - lse),
    so p = 1 on each key of a row whose every key is masked); under GQA each
    kv head sums its query heads in fp32 before the cast."""
    b, h, _, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    s = _scores(q, _heads_like_q(k, h), bias)
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, _heads_like_q(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dk = dk.view(b, kvh, h // kvh, lk, d).sum(dim=2)
    dv = dv.view(b, kvh, h // kvh, lk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_shapes(q, k, v, dout, stats,
                      aligned: bool = True) -> tuple[int, int, int, int, int, int]:
    """Devices, dtypes and shapes of a backward kernel's operands (`aligned`:
    see `_check_operand`); returns (B, H, KVH, Lq, Lk, D)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_operand(name, t, q.device, aligned=aligned)
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


def _heads_fastest(bias: torch.Tensor) -> int:
    """The grid order of the biased wgmma kernels that stream a bias tile a
    step (B4-bias, B5-dq-bias, B5-dkv-bias; 1: heads fastest). A bias
    broadcast over the heads runs a tile's heads side by side, so its rows
    come from HBM about once; a per-head bias runs a head's tiles side by
    side, as the unbiased kernels do."""
    return int(describe_bias(bias, STEP_ROWS).dims[2] == 1)


def _dq_maps(q, k, v, dout, dq) -> list:
    """The tensor maps of a wgmma dq kernel's operands (B3's, B5-dq's): q and
    dO read as resident tiles of 128 rows, k and v as streamed tiles of 64
    keys, dq stored 64 rows at a time."""
    return [describe(q, TILE_ROWS), describe(k, STEP_ROWS), describe(v, STEP_ROWS),
            describe(dout, TILE_ROWS), describe(dq, OUT_ROWS)]


def _dkv_maps(q, k, v, dout, dk, dv, lse, delta) -> list:
    """The descriptions of a wgmma dkv kernel's operands (B3's, B5-dkv's): k
    and v read as resident tiles of 128 rows, q and dO as streamed tiles of
    64 query rows, dk and dv stored 64 rows at a time, lse and delta read in
    spans of 64 rows."""
    return [describe(q, STEP_ROWS), describe(k, TILE_ROWS), describe(v, TILE_ROWS),
            describe(dout, STEP_ROWS), describe(dk, OUT_ROWS), describe(dv, OUT_ROWS),
            describe_rows(lse, STEP_ROWS), describe_rows(delta, STEP_ROWS)]


def _launch_dq_wgmma(source: str, prefix: str, wrapper, q, k, v, dout, delta, bias=None):
    """(dq, lse) through a wgmma dq kernel, the C entry `mmada_<prefix>_dq_bf16`
    (`_dq_bias_bf16` with a bias) of the library built from
    `csrc/<source>.cu`: B3's or B5-dq's. q, k, v, dO (and the bias) are read
    through tensor maps, an operand no map describes copied first (a bias so
    copied counts in `wrapper.bias_copies`); dq is stored by TMA."""
    b, h, kvh, lq, lk, d = _check_bwd_shapes(q, k, v, dout, [("delta", delta)], aligned=False)
    q, k, v, dout = (tma_operand(t) for t in (q, k, v, dout))
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    maps = _dq_maps(q, k, v, dout, dq)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), delta.data_ptr()]
    tail, name = (), f"mmada_{prefix}_dq_bf16"
    if bias is not None:
        bias = _bias_map_operand(wrapper, bias, b, h, lq, lk, q.device)
        maps.append(describe_bias(bias, TILE_ROWS))
        ptrs.append(bias.data_ptr())
        tail, name = (_heads_fastest(bias),), f"mmada_{prefix}_dq_bias_bf16"
    ptrs += [dq.data_ptr(), lse.data_ptr()]
    args = spec_array(*maps)
    args.extend(tail)
    _launch(_entry(source, name, len(ptrs), arrays=1), q.device, *ptrs, b, h, kvh, lq, lk, d,
            args.buffer_info()[0], 1.0 / (d ** 0.5))
    return dq, lse


def _launch_dkv_wgmma(source: str, prefix: str, wrapper, q, k, v, dout, lse, delta,
                      bias=None):
    """(dk, dv) through a wgmma dkv kernel, the C entry
    `mmada_<prefix>_dkv_bf16` (`_dkv_bias_bf16` with a bias) of the library
    built from `csrc/<source>.cu`: B3's or B5-dkv's. q, k, v, dO (and the
    bias) are read through tensor maps, lse and delta in spans of 64 rows
    (each copied first if it cannot be read so; a bias so copied counts in
    `wrapper.bias_copies`); dk and dv are stored by TMA."""
    b, h, kvh, lq, lk, d = _check_bwd_shapes(q, k, v, dout, [("lse", lse), ("delta", delta)],
                                             aligned=False)
    q, k, v, dout = (tma_operand(t) for t in (q, k, v, dout))
    lse, delta = rows_operand(lse), rows_operand(delta)
    dk = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    maps = _dkv_maps(q, k, v, dout, dk, dv, lse, delta)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr()]
    tail, name = (), f"mmada_{prefix}_dkv_bf16"
    if bias is not None:
        bias = _bias_map_operand(wrapper, bias, b, h, lq, lk, q.device)
        maps.append(describe_bias(bias, STEP_ROWS))
        ptrs.append(bias.data_ptr())
        tail, name = (_heads_fastest(bias),), f"mmada_{prefix}_dkv_bias_bf16"
    ptrs += [dk.data_ptr(), dv.data_ptr()]
    args = spec_array(*maps)
    args.extend(tail)
    _launch(_entry(source, name, len(ptrs), arrays=1), q.device, *ptrs, b, h, kvh, lq, lk, d,
            args.buffer_info()[0], 1.0 / (d ** 0.5))
    return dk, dv


def _launch_bwd_dq(q, k, v, dout, delta, bias):
    """Check the operands, allocate (dq, lse) and launch B3's dq kernel (on
    wgmma, `_launch_dq_wgmma`, on a persistent grid: each cluster walks
    several (tile pair, head, batch) items) or B3-bias's (mma.sync, element
    strides)."""
    if bias is None:
        return _launch_dq_wgmma(_BWD_SOURCE, "flash_attention_bwd", attention_bwd_dq, q, k, v,
                                dout, delta)
    b, h, kvh, lq, lk, d = _check_bwd_shapes(q, k, v, dout, [("delta", delta)])
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            bias.data_ptr(), dq.data_ptr(), lse.data_ptr()]
    bias_strides = _bias_strides(bias, b, h, lq, lk, q.device)
    _launch(_entry(_BWD_SOURCE, "mmada_flash_attention_bwd_dq_bias_bf16", len(ptrs)), q.device,
            *ptrs, b, h, kvh, lq, lk, d, _strides(q, k, v, dout, dq, extra=bias_strides),
            1.0 / (d ** 0.5))
    return dq, lse


def _launch_bwd_dkv(q, k, v, dout, lse, delta, bias):
    """Check the operands, allocate (dk, dv) and launch B3's dkv kernel (on
    wgmma, `_launch_dkv_wgmma`) or B3-bias's (mma.sync, element strides)."""
    if bias is None:
        return _launch_dkv_wgmma(_BWD_SOURCE, "flash_attention_bwd", attention_bwd_dkv, q, k,
                                 v, dout, lse, delta)
    b, h, kvh, lq, lk, d = _check_bwd_shapes(
        q, k, v, dout, [("lse", lse), ("delta", delta)])
    dk = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), bias.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    bias_strides = _bias_strides(bias, b, h, lq, lk, q.device)
    _launch(_entry(_BWD_SOURCE, "mmada_flash_attention_bwd_dkv_bias_bf16", len(ptrs)),
            q.device, *ptrs, b, h, kvh, lq, lk, d,
            _strides(q, k, v, dout, dk, dv, extra=bias_strides), 1.0 / (d ** 0.5))
    return dk, dv


def attention_bwd_dq(q, k, v, dout, delta, bias=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dq, lse) through the Hopper dq kernel (CUDA tensors) or its plain
    version (CPU tensors). Counts launches in `attention_bwd_dq.launches`
    (B3, which reads its operands through tensor maps), or
    `attention_bwd_dq.bias_launches` with a bias (B3-bias)."""
    if q.device.type == "cpu":
        return attention_bwd_dq_reference(q, k, v, dout, delta, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dq runs on cuda or cpu, not {q.device}")
    bias = bias_as_float(bias)
    out = _launch_bwd_dq(q, k, v, dout, delta, bias)
    _count_launch(attention_bwd_dq, bias)
    return out


attention_bwd_dq.launches = 0
attention_bwd_dq.bias_launches = 0


def attention_bwd_dkv(q, k, v, dout, lse, delta, bias=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) through the Hopper dkv kernel (CUDA tensors) or its plain
    version (CPU tensors). Counts launches in `attention_bwd_dkv.launches`
    (B3, which reads its operands through tensor maps), or
    `attention_bwd_dkv.bias_launches` with a bias (B3-bias)."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_reference(q, k, v, dout, lse, delta, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dkv runs on cuda or cpu, not {q.device}")
    bias = bias_as_float(bias)
    out = _launch_bwd_dkv(q, k, v, dout, lse, delta, bias)
    _count_launch(attention_bwd_dkv, bias)
    return out


attention_bwd_dkv.launches = 0
attention_bwd_dkv.bias_launches = 0


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, contiguous (B, H, Lq)."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def flash_attention_bwd(
    q: torch.Tensor,     # (B, H, Lq, D), rotated
    k: torch.Tensor,     # (B, KVH, Lk, D), rotated
    v: torch.Tensor,
    out: torch.Tensor,   # the forward's output
    dout: torch.Tensor,  # its cotangent
    bias: Optional[torch.Tensor] = None,  # (B|1, H|1, Lq, Lk)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): delta, then the dq kernel (which also gives the row
    logsumexp), then the dkv kernel; plain versions for CPU tensors. No
    gradient goes to the bias."""
    bias = bias_as_float(bias)
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv(q, k, v, dout, lse, delta, bias)
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, out, dout, bias=None):
    """`flash_attention_bwd` through the plain versions, on any device."""
    bias = bias_as_float(bias)
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq_reference(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv_reference(q, k, v, dout, lse, delta, bias)
    return dq, dk, dv
