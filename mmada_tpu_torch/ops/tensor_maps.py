"""How the wgmma attention kernels (B1, B4) see their operands: TMA tensor maps.

The kernels in `csrc/flash_attention_fwd.cu` (B1) and
`csrc/flash_attention_long.cu` (B4) read q, k and v and write the output
through TMA, which copies a whole box of a tensor between device and shared
memory. A tensor map describes a bf16 (B, H, L, D) operand to TMA; the wrapper
writes that description here, in Python, and the C entry only encodes it
(`encode_tensor_map` in `csrc/hopper_sm90.cuh`):

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
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

BOX_COLS = 64   # bf16 columns of one box: 128 bytes
ALIGN_BYTES = 16
# box rows of the kernels' tiles (ATT_M and ATT_N in csrc/hopper_sm90.cuh):
# q, k and v in tiles of 128 rows; the output stored 64 rows (one consumer
# warpgroup's) at a time
TILE_ROWS = 128
OUT_ROWS = 64


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


def spec_array(*specs: TensorMapSpec, head: tuple = ()) -> array.array:
    """The descriptions as the C entry takes them, one long long array
    (after the values in `head`, if any); the C entry gets its address,
    `.buffer_info()[0]`."""
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
