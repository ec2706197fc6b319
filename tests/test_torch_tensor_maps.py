"""The tensor maps through which the wgmma attention kernels (B1, B4) read
their operands and write their output, as the wrappers describe them
(`mmada_tpu_torch/ops/tensor_maps.py`): dims in (columns, rows, heads,
batches) order, byte strides that are multiples of 16, the box, and a copy
of an operand no map can describe. These run on the CPU: the description
is Python, and the kernels that take it run on the card
(`tests/test_torch_cuda.py`)."""

import pytest
import torch

from mmada_tpu_torch.ops import flash_attention as fa_mod
from mmada_tpu_torch.ops.tensor_maps import (
    OUT_ROWS,
    TILE_ROWS,
    TensorMapSpec,
    describable,
    describe,
    spec_array,
    tma_operand,
)


def _aligned(*shape, dtype=torch.bfloat16):
    """A tensor of random values whose base is 16-byte aligned (the
    allocator's blocks are)."""
    t = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(dtype)
    assert t.data_ptr() % 16 == 0
    return t


def _check_spec(spec: TensorMapSpec, t: torch.Tensor, box_rows: int) -> None:
    b, h, l, d = t.shape
    assert spec.dims == (d, l, h, b)            # columns, rows, heads, batches
    assert all(s % 16 == 0 and s > 0 for s in spec.strides)
    assert spec.box == (min(d, 64), box_rows, 1, 1)
    assert spec.box[0] * 2 <= 128               # within the 128-byte swizzle
    # every stride of a dim longer than 1 is the tensor's own, in bytes
    for extent, stride, step in zip((l, h, b), (t.stride(2), t.stride(1), t.stride(0)),
                                    spec.strides):
        if extent > 1:
            assert step == stride * t.element_size()
    assert len(spec.flat()) == 11


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_fused_projection_views_are_read_in_place(d, h, kvh):
    """q, k, v as the model passes them: head views of one (B, L, (H + 2 KVH)
    D) projection, (B, H, L, D) after `.view(...).transpose(1, 2)`. Their
    row stride is the projection's width, their head stride D: no copy."""
    b, l = 2, 387
    fused = _aligned(b, l, (h + 2 * kvh) * d)
    q, k, v = fused.split([h * d, kvh * d, kvh * d], dim=-1)
    q = q.view(b, l, h, d).transpose(1, 2)
    k = k.view(b, l, kvh, d).transpose(1, 2)
    v = v.view(b, l, kvh, d).transpose(1, 2)
    width = (h + 2 * kvh) * d * 2
    for t, heads in ((q, h), (k, kvh), (v, kvh)):
        assert describable(t)
        assert tma_operand(t) is t
        spec = describe(t, TILE_ROWS)
        _check_spec(spec, t, TILE_ROWS)
        assert spec.dims == (d, l, heads, b)
        assert spec.strides == (width, d * 2, l * width)


@pytest.mark.parametrize("d", [64, 128])
def test_rotated_scratch_and_gqa_kv_are_contiguous_maps(d):
    """The RoPE pass writes contiguous (B, H, L, D) q and (B, KVH, L, D) k;
    GQA k and v arrive as contiguous (B, KVH, L, D) too."""
    b, h, kvh, l = 3, 8, 2, 159
    for heads in (h, kvh):
        t = _aligned(b, heads, l, d)
        spec = describe(t, TILE_ROWS)
        _check_spec(spec, t, TILE_ROWS)
        assert spec.strides == (d * 2, l * d * 2, heads * l * d * 2)


@pytest.mark.parametrize("d", [64, 128])
def test_output_view_is_written_in_place(d):
    """The wrappers allocate the output as (B, Lq, H, D) and hand the kernel
    its (B, H, Lq, D) transpose, so the caller's merge of the heads is a
    view; the kernel stores it in boxes of 64 rows."""
    b, h, lq = 4, 32, 1155
    out = _aligned(b, lq, h, d).transpose(1, 2)
    spec = describe(out, OUT_ROWS)
    _check_spec(spec, out, OUT_ROWS)
    assert spec.dims == (d, lq, h, b)
    assert spec.strides == (h * d * 2, d * 2, lq * h * d * 2)
    assert spec.box == (min(d, 64), 64, 1, 1)


def test_dims_of_size_one_take_contiguous_strides():
    """A head or batch of one is never stepped over; whatever stride torch
    reports for it (a broadcast 0, an odd number), the map's stays a
    multiple of 16."""
    t = _aligned(1, 1, 7, 64).as_strided((1, 1, 7, 64), (3, 5, 64, 1))
    assert describable(t)
    spec = describe(t, TILE_ROWS)
    assert spec.strides == (128, 7 * 128, 7 * 128)
    one_row = _aligned(2, 3, 1, 128)
    assert describe(one_row, TILE_ROWS).strides == (256, 256, 768)


@pytest.mark.parametrize("make", [
    lambda: _aligned(1, 2, 64, 72)[..., 1:65],           # base 2 bytes off
    lambda: _aligned(1, 2, 64, 68)[..., :64],            # row stride 136 bytes
    lambda: _aligned(1, 2, 64, 256)[..., ::2],           # strided columns
    lambda: _aligned(1, 3, 64, 64).as_strided((1, 2, 64, 64), (0, 4100, 64, 1)),
])
def test_an_operand_no_map_describes_is_copied(make):
    t = make()
    assert not describable(t)
    with pytest.raises(ValueError, match="copy it first"):
        describe(t, TILE_ROWS)
    copied = tma_operand(t)
    assert copied is not t and copied.is_contiguous() and torch.equal(copied, t)
    _check_spec(describe(copied, TILE_ROWS), copied, TILE_ROWS)


def test_spec_array_is_the_c_layout():
    """The C entry reads MAP_SPEC = 11 long longs per operand: dims, byte
    strides, box."""
    a = describe(_aligned(1, 2, 64, 128), TILE_ROWS)
    b = describe(_aligned(1, 64, 2, 128).transpose(1, 2), OUT_ROWS)
    arr = spec_array(a, b)
    assert list(arr) == a.flat() + b.flat()
    assert a.flat() == [128, 64, 2, 1, 256, 64 * 256, 2 * 64 * 256, 64, 128, 1, 1]
    # B = 1: the batch stride is the contiguous one, heads x their stride
    assert b.flat() == [128, 64, 2, 1, 2 * 256, 256, 2 * 256, 64, 64, 1, 1]


def test_wrappers_leave_cpu_tensors_to_the_plain_version():
    """On the CPU the wrappers compute the plain version and describe
    nothing: a view no map takes gives the plain version's output."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 40, 72, generator=g).bfloat16()[..., 1:65]
    k = torch.randn(1, 2, 40, 72, generator=g).bfloat16()[..., 1:65]
    v = torch.randn(1, 2, 40, 72, generator=g).bfloat16()[..., 1:65]
    before = fa_mod.flash_attention.launches
    got = fa_mod.flash_attention(q, k, v)
    assert fa_mod.flash_attention.launches == before
    torch.testing.assert_close(got, fa_mod.flash_attention_reference(q, k, v), atol=0, rtol=0)
