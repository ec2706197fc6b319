"""How the wgmma kernels (B1-B6) see their operands: TMA tensor maps.

The kernels in `csrc/flash_attention_fwd.cu` (B1, B2),
`csrc/flash_attention_bwd.cu` (B3) and `csrc/flash_attention_long.cu` (B4,
B5-dq, B5-dkv, biased or not) read their bf16 operands and write their
outputs through TMA, which copies a whole box of a tensor between device and
shared memory. A tensor map describes a bf16 (B, H, L,
D) operand to TMA; the wrapper writes that description here, in Python, and
the C entry only encodes it (`encode_tensor_map` in `csrc/hopper_sm90.cuh`):

  * dims, innermost first: (D, rows, heads, batches), so that a box
    coordinate is (column, row, head, batch) whatever the tensor's layout;
  * the byte strides of a row, a head and a batch (the columns are
    contiguous);
  * the box: 64 columns (128 bytes, the width of the 128-byte swizzle the
    kernels' wgmma descriptors name; a D = 128 tile is two boxes) or D if
    smaller, `box_rows` rows, one head, one batch.

TMA takes a base address and strides that are multiples of 16 bytes and
contiguous columns. A strided head view of a fused projection meets that, so
it is read in place; an operand that does not (an odd element offset, a
stride that is not a multiple of 8 elements, strided columns) is copied with
`.contiguous()` first (`tma_operand`), never sent to another path. A dim of
size 1 is never stepped over, so its stride is replaced by the contiguous
one, which keeps it a multiple of 16 whatever torch reports for it.

The biased kernels (B2, B4-bias, B5-dq-bias, B5-dkv-bias) read the fp32 bias (B|1,
H|1, Lq, Lk) through a map too (`describe_bias`): dims (Lk, Lq, heads,
batches), boxes of 32 columns (128 bytes, the swizzle's width) and the
kernel's rows. A broadcast axis (extent 1, or a stride of 0 as `expand`
gives) is a dimension of 1 that the kernel reads at index 0. The rows must
start 16 bytes apart: a mask bias of odd L does not, so the model builds its
bias with rows padded to ROW_FLOATS (4) floats, a view of the first L
columns as `aligned_rows` makes, and a wrapper copies any other bias once
(`bias_operand`).

The int4 matmul (B6, `csrc/int4_matmul.cu`) reads 2-D operands through maps
of their own (`describe_matrix`): bf16 x (M, K) in boxes of 64 columns and
the kernel's 128 or 256 tile rows, the int8 packed weight (K/2, N) in boxes
of 128 x 64 bytes, its fp32 scales (K/128, N) in boxes of 128 x 1, and the
bf16 output (M, N) written 64 x 64 at a time; dims (columns, rows, 1, 1). A
column window of a wide weight or one layer of a stacked one is read in
place; a view whose base or row stride is not a multiple of 16 bytes is
refused (B6's wrapper checks its operands first).

The dkv kernels (B3's, B5-dkv) also read the fp32 row statistics lse and
delta (contiguous (B, H, Lq)) in spans of 64 values: B5-dkv with 1-D bulk
copies (its Lq a multiple of 128, so every span starts 16 bytes aligned), B3
with ordinary loads (at Lq 387 a (batch, head)'s rows start 1,548 bytes
apart, where no bulk copy or TMA box may start). `describe_rows` says what
the C entry checks of them, and `rows_operand` copies one whose base is not
16-byte aligned.
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

BOX_COLS = 64   # bf16 columns of one box: 128 bytes
ALIGN_BYTES = 16
MAX_BOX = 256   # elements of a box along any dimension (TMA's limit)
# box rows of the kernels' tiles (ATT_M and ATT_N in csrc/hopper_sm90.cuh):
# q, k and v in tiles of 128 rows (the resident q and dO of the dq kernels
# and B4-bias, k and v of the dkv kernels; the bias tiles of B2, B4-bias and
# B5-dq-bias); the output stored 64 rows (one consumer warpgroup's) at a
# time; 64-row tiles (STEP_N in csrc/hopper_sm90.cuh): the K and V tiles of
# 64 keys of B2, B4-bias and the dq kernels, the dkv kernels' q and dO
# tiles, bias tiles and lse / delta spans of 64 queries
TILE_ROWS = 128
OUT_ROWS = 64
STEP_ROWS = 64
BIAS_COLS = 32  # fp32 columns of one bias box: 128 bytes (BIAS_COLS in csrc/hopper_sm90.cuh)
ROW_FLOATS = ALIGN_BYTES // 4  # a bias row's length is padded to a multiple of this


class TensorMapSpec(NamedTuple):
    """What the C entry encodes for one operand (`MAP_SPEC` = 11 values)."""

    dims: tuple[int, int, int, int]     # (D, rows, heads, batches)
    strides: tuple[int, int, int]       # bytes between rows, heads, batches
    box: tuple[int, int, int, int]      # (columns, rows, 1, 1)

    def flat(self) -> list[int]:
        return [*self.dims, *self.strides, *self.box]


# Plain loops and an array.array below: the wrappers describe four operands
# on every launch, and a B1 launch at the served text batch takes about 20 us
# on the card, less than a ctypes array of 44 values takes to build.

def describable(t: torch.Tensor) -> bool:
    """Whether a tensor map can describe t as it is: 4-D, contiguous
    columns, base and every stride of a dim longer than 1 multiples of 16
    bytes."""
    shape, stride = t.shape, t.stride()
    if len(shape) != 4 or (shape[3] > 1 and stride[3] != 1) or t.data_ptr() % ALIGN_BYTES:
        return False
    size = t.element_size()
    for i in range(3):
        if shape[i] > 1 and stride[i] * size % ALIGN_BYTES:
            return False
    return True


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself if a tensor map can describe it, else a contiguous copy."""
    return t if describable(t) else t.contiguous()


def describe(t: torch.Tensor, box_rows: int) -> TensorMapSpec:
    """The tensor map of a (B, H, L, D) operand, read or written in boxes of
    `box_rows` rows. Raises if t is not `describable` (the wrapper copies
    such an operand first)."""
    shape, stride, size = t.shape, t.stride(), t.element_size()
    if not describable(t):
        raise ValueError(f"no tensor map describes shape {tuple(shape)} strides "
                         f"{stride} at offset {t.data_ptr() % ALIGN_BYTES}: copy it first")
    b, h, l, d = shape
    if d * size % ALIGN_BYTES:
        raise ValueError(f"rows of {d} elements are not a multiple of {ALIGN_BYTES} bytes")
    # a dim of size 1 takes the contiguous stride: the next inner one's span
    rows = stride[2] * size if l > 1 else d * size
    heads = stride[1] * size if h > 1 else rows * l
    batches = stride[0] * size if b > 1 else heads * h
    return TensorMapSpec((d, l, h, b), (rows, heads, batches),
                         (min(d, BOX_COLS), box_rows, 1, 1))


def _bias_axes(t: torch.Tensor) -> tuple[bool, bool]:
    """Whether the bias's batch and head axes are broadcast: extent 1, or
    stride 0 (an expanded view)."""
    return tuple(t.shape[i] == 1 or t.stride(i) == 0 for i in range(2))


def bias_describable(t: torch.Tensor) -> bool:
    """Whether a tensor map can describe the fp32 bias t as it is: 4-D,
    contiguous columns, base and the strides of every axis that is stepped
    over (rows; heads and batches unless broadcast) multiples of 16 bytes."""
    if t.dtype != torch.float32 or t.dim() != 4 or t.data_ptr() % ALIGN_BYTES:
        return False
    if t.shape[3] > 1 and t.stride(3) != 1:
        return False
    stepped = [2] if t.shape[2] > 1 else []
    stepped += [i for i, broadcast in enumerate(_bias_axes(t)) if not broadcast]
    return all(t.stride(i) * 4 % ALIGN_BYTES == 0 for i in stepped)


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """t's values as a view of the first L columns of a tensor whose rows
    are padded to a multiple of 4 floats (16 bytes), its other strides
    contiguous: what a bias map can describe."""
    lk = t.shape[-1]
    padded = torch.empty((*t.shape[:-1], lk + -lk % ROW_FLOATS), dtype=t.dtype,
                         device=t.device)
    view = padded[..., :lk]
    view.copy_(t)
    return view


def bias_operand(t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(bias, copied): t itself if a bias map can describe it, else a copy
    with broadcast axes of extent 1 and rows padded (`aligned_rows`)."""
    if bias_describable(t):
        return t, False
    batch, head = _bias_axes(t)
    return aligned_rows(t[:1 if batch else None, :1 if head else None]), True


def describe_bias(t: torch.Tensor, box_rows: int) -> TensorMapSpec:
    """The tensor map of an fp32 bias (B|1, H|1, Lq, Lk), read in boxes of
    BIAS_COLS columns and `box_rows` rows: dims (Lk, Lq, heads, batches), a
    broadcast axis of extent 1. Raises if t is not `bias_describable` (the
    wrapper copies such a bias first, `bias_operand`)."""
    if not bias_describable(t):
        raise ValueError(f"no tensor map describes the bias of shape {tuple(t.shape)} strides "
                         f"{t.stride()} at offset {t.data_ptr() % ALIGN_BYTES}: copy it first")
    batch, head = _bias_axes(t)
    b, h = (1 if batch else t.shape[0]), (1 if head else t.shape[1])
    lq, lk = t.shape[2], t.shape[3]
    rows = t.stride(2) * 4 if lq > 1 else (lk + -lk % ROW_FLOATS) * 4
    heads = t.stride(1) * 4 if h > 1 else rows * lq
    batches = t.stride(0) * 4 if b > 1 else heads * h
    return TensorMapSpec((lk, lq, h, b), (rows, heads, batches), (BIAS_COLS, box_rows, 1, 1))


class RowsSpec(NamedTuple):
    """What the C entry checks of an fp32 row-statistics operand (`ROWS_SPEC`
    = 4 values): its extents and the bytes of one span it reads at a
    time."""

    dims: tuple[int, int, int]          # (rows, heads, batches)
    span_bytes: int

    def flat(self) -> list[int]:
        return [*self.dims, self.span_bytes]


def _rows_aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % ALIGN_BYTES == 0


def rows_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself if bulk copies can read it (contiguous, base 16-byte
    aligned), else an aligned contiguous copy."""
    return t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)


def describe_rows(t: torch.Tensor, span_rows: int) -> RowsSpec:
    """The description of fp32 (B, H, L) row statistics read `span_rows`
    values at a time, at any L (B3 reads a ragged last span with ordinary
    loads, masked; B5's L is a multiple of the span). Raises unless t is
    contiguous fp32, its base 16-byte aligned (`rows_operand` copies one
    that is not) and a span a multiple of 16 bytes and at most MAX_BOX
    values (a bulk copy's and a TMA box's limits)."""
    if t.dtype != torch.float32 or t.dim() != 3:
        raise ValueError(f"row statistics must be fp32 (B, H, L), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not _rows_aligned(t):
        raise ValueError(f"row statistics must be contiguous with a 16-byte aligned base "
                         f"(offset {t.data_ptr() % ALIGN_BYTES}): copy it first")
    b, h, l = t.shape
    span = span_rows * t.element_size()
    if span % ALIGN_BYTES or not 0 < span_rows <= MAX_BOX:
        raise ValueError(f"spans of {span_rows} rows are not a box of 16-byte pieces of at "
                         f"most {MAX_BOX} values")
    return RowsSpec((l, h, b), span)


def describe_matrix(t: torch.Tensor, box_cols: int, box_rows: int) -> TensorMapSpec:
    """The tensor map of a 2-D (rows, columns) operand (B6's x, packed
    weight, scales and output), read or written in boxes of box_cols x
    box_rows: dims (columns, rows, 1, 1), the byte stride of a row (the
    contiguous one for a single row), the dims of 1 stepped over by the
    whole matrix. Raises unless the columns are contiguous and the base and
    the row stride are multiples of 16 bytes."""
    if t.dim() != 2:
        raise ValueError(f"a matrix map describes 2-D tensors, got {tuple(t.shape)}")
    rows, cols = t.shape
    size = t.element_size()
    row_bytes = t.stride(0) * size if rows > 1 else cols * size
    if ((cols > 1 and t.stride(1) != 1) or t.data_ptr() % ALIGN_BYTES
            or row_bytes % ALIGN_BYTES or cols * size % ALIGN_BYTES):
        raise ValueError(f"no tensor map describes shape {tuple(t.shape)} strides {t.stride()} "
                         f"at offset {t.data_ptr() % ALIGN_BYTES}: rows must be contiguous and "
                         f"start {ALIGN_BYTES} bytes apart")
    if not (0 < box_cols <= MAX_BOX and 0 < box_rows <= MAX_BOX):
        raise ValueError(f"a box of {box_cols} x {box_rows} exceeds {MAX_BOX} a dimension")
    whole = row_bytes * rows
    return TensorMapSpec((cols, rows, 1, 1), (row_bytes, whole, whole),
                         (box_cols, box_rows, 1, 1))


def spec_array(*specs, head: tuple = ()) -> array.array:
    """The descriptions (`TensorMapSpec`s, then any `RowsSpec`s) as the C
    entry takes them, one long long array (after the values in `head`, if
    any); the C entry gets its address, `.buffer_info()[0]`."""
    flat = list(head)
    for s in specs:
        flat += s.flat()
    return array.array("q", flat)


def wgmma_tile_product(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """(s, o) of one tile through the kernels' TMA loads and wgmma products
    (`wgmma_tile_kernel` in csrc/flash_attention_fwd.cu), for the card test
    that pins the tensor maps, the descriptors and the swizzle: a (64, 128),
    b and v (128, 128) bf16 on the card; s = a . b^T and o = bf16(s) . v in
    fp32 (64, 128)."""
    from mmada_tpu_torch.ops import _build

    if a.device.type != "cuda":
        raise ValueError("the tile product runs on the card only")
    a, b, v = (tma_operand(t.reshape(1, 1, *t.shape)) for t in (a, b, v))
    s_out = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    o_out = torch.empty_like(s_out)
    fn = _build.load_library("flash_attention_fwd").mmada_wgmma_tile_bf16
    p = ctypes.c_void_p
    fn.argtypes = [p] * 7
    fn.restype = ctypes.c_int
    maps = spec_array(describe(a, 64), describe(b, TILE_ROWS), describe(v, TILE_ROWS))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), s_out.data_ptr(), o_out.data_ptr(),
                 maps.buffer_info()[0], torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mmada_wgmma_tile_bf16 launch failed: cudaError {err}")
    return s_out, o_out


def bias_tile_read(bias: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The fp32 bias tile as the biased kernels read it from shared memory
    (`bias_tile_kernel` in csrc/flash_attention_long.cu), for the card test
    that pins the bias map's swizzle against the kernels' reads: `bias`
    (128, 64) read row-wise as B2 and B5-dq-bias do (out = bias), or (64,
    128) read transposed as B5-dkv-bias does (out = bias^T); out (128, 64)
    fp32."""
    from mmada_tpu_torch.ops import _build

    if bias.device.type != "cuda":
        raise ValueError("the bias tile read runs on the card only")
    want = (64, 128) if transposed else (128, 64)
    if tuple(bias.shape) != want or bias.dtype != torch.float32:
        raise ValueError(f"the bias tile is fp32 {want}, got {bias.dtype} {tuple(bias.shape)}")
    bias, _ = bias_operand(bias.reshape(1, 1, *want))
    out = torch.empty((128, 64), dtype=torch.float32, device=bias.device)
    fn = _build.load_library("flash_attention_long").mmada_bias_tile_f32
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    spec = spec_array(describe_bias(bias, want[0]))
    with torch.cuda.device(bias.device):
        err = fn(bias.data_ptr(), out.data_ptr(), int(transposed), spec.buffer_info()[0],
                 torch.cuda.current_stream(bias.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mmada_bias_tile_f32 launch failed: cudaError {err}")
    return out


def wgmma_bwd_tile_product(x: torch.Tensor, y: torch.Tensor):
    """(s, o) through the backward kernels' operand roles
    (`wgmma_bwd_tile_kernel` in csrc/flash_attention_long.cu), for the card
    test: x (128, D) read as a resident tile (boxes of 128 rows), y (64, D)
    as a streamed tile (boxes of 64 rows), bf16 on the card, D 64 or 128;
    s = x[64:] . y^T (64, 64) with y K-major and o = bf16(s) . y (64, D) with
    y MN-major from the same shared memory, both fp32."""
    from mmada_tpu_torch.ops import _build

    if x.device.type != "cuda":
        raise ValueError("the tile product runs on the card only")
    d = x.shape[1]
    x, y = (tma_operand(t.reshape(1, 1, *t.shape)) for t in (x, y))
    s_out = torch.empty((64, 64), dtype=torch.float32, device=x.device)
    o_out = torch.empty((64, d), dtype=torch.float32, device=x.device)
    fn = _build.load_library("flash_attention_long").mmada_wgmma_bwd_tile_bf16
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    maps = spec_array(describe(x, TILE_ROWS), describe(y, STEP_ROWS))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), s_out.data_ptr(), o_out.data_ptr(), d,
                 maps.buffer_info()[0], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mmada_wgmma_bwd_tile_bf16 launch failed: cudaError {err}")
    return s_out, o_out
