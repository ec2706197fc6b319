"""How the wgmma attention kernels (B1, B4, B5) see their operands: TMA tensor maps.

The kernels in `csrc/flash_attention_fwd.cu` (B1) and
`csrc/flash_attention_long.cu` (B4, B5-dq, B5-dkv) read their bf16 operands
and write their outputs through TMA, which copies a whole box of a tensor
between device and shared memory. A tensor map describes a bf16 (B, H, L,
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

B5-dkv also copies spans of the fp32 row statistics lse and delta
(contiguous (B, H, Lq)) with 1-D bulk copies: `describe_rows` says what the
C entry checks of them, and `rows_operand` copies one whose base is not
16-byte aligned.
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

BOX_COLS = 64   # bf16 columns of one box: 128 bytes
ALIGN_BYTES = 16
# box rows of the kernels' tiles (ATT_M and ATT_N in csrc/hopper_sm90.cuh):
# q, k and v in tiles of 128 rows (B5: the resident q and dO of B5-dq, k and
# v of B5-dkv); the output stored 64 rows (one consumer warpgroup's) at a
# time; B5's streamed tiles (BWD_N in csrc/flash_attention_long.cu): B5-dq's
# K and V tiles of 64 keys, B5-dkv's q and dO tiles and lse / delta spans of
# 64 queries
TILE_ROWS = 128
OUT_ROWS = 64
STEP_ROWS = 64


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


class RowsSpec(NamedTuple):
    """What the C entry checks of an fp32 row-statistics operand (`ROWS_SPEC`
    = 4 values): its extents and the bytes of one span it copies."""

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
    """The description of fp32 (B, H, L) row statistics copied `span_rows`
    values at a time. Raises unless t is contiguous fp32, its base 16-byte
    aligned (`rows_operand` copies one that is not) and a span a multiple
    of 16 bytes that divides L."""
    if t.dtype != torch.float32 or t.dim() != 3:
        raise ValueError(f"row statistics must be fp32 (B, H, L), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not _rows_aligned(t):
        raise ValueError(f"row statistics must be contiguous with a 16-byte aligned base "
                         f"(offset {t.data_ptr() % ALIGN_BYTES}): copy it first")
    b, h, l = t.shape
    span = span_rows * t.element_size()
    if span % ALIGN_BYTES or l % span_rows:
        raise ValueError(f"spans of {span_rows} rows do not tile L {l} in 16-byte pieces")
    return RowsSpec((l, h, b), span)


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
