"""The tensor maps through which the wgmma attention kernels (B1, B4, B5-dq,
B5-dkv) read their operands and write their outputs, as the wrappers
describe them (`mmada_tpu_torch/ops/tensor_maps.py`): dims in (columns,
rows, heads, batches) order, byte strides that are multiples of 16, the box,
and a copy of an operand no map can describe; and the spans of fp32 row
statistics (lse, delta) that B5-dkv copies in bulk. These run on the CPU:
the description is Python, and the kernels that take it run on the card
(`tests/test_torch_cuda.py`)."""

import pytest
import torch

from mmada_tpu_torch.ops import flash_attention as fa_mod
from mmada_tpu_torch.ops import flash_attention_long as long_mod
from mmada_tpu_torch.ops.tensor_maps import (
    OUT_ROWS,
    STEP_ROWS,
    TILE_ROWS,
    RowsSpec,
    TensorMapSpec,
    describable,
    describe,
    describe_rows,
    rows_operand,
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


# ---------------------------------------------------------------- B5-dq, B5-dkv

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_b5_maps_of_the_long_backward(d, h, kvh):
    """The maps B5's wrappers hand the kernels at a long frame: B5-dq reads q
    and dO as resident tiles of 128 rows and k, v as streamed tiles of 64
    keys, and stores dq 64 rows at a time; B5-dkv reads k and v as resident
    tiles of 128 rows and q, dO as streamed tiles of 64 query rows, and stores
    dk and dv (B, KVH, Lk, D) 64 rows at a time. dO and dq are described as q
    is, dk and dv as k is."""
    b, lq, lk = 2, 4224, 4352
    q, dout, dq = (_aligned(b, h, lq, d) for _ in range(3))
    k, v, dk, dv = (_aligned(b, kvh, lk, d) for _ in range(4))
    assert STEP_ROWS == 64 and TILE_ROWS == 128 and OUT_ROWS == 64
    for t, rows in ((q, TILE_ROWS), (dout, TILE_ROWS), (k, STEP_ROWS), (v, STEP_ROWS),
                    (dq, OUT_ROWS)):                          # B5-dq
        _check_spec(describe(t, rows), t, rows)
    for t, rows in ((q, STEP_ROWS), (dout, STEP_ROWS), (k, TILE_ROWS), (v, TILE_ROWS),
                    (dk, OUT_ROWS), (dv, OUT_ROWS)):          # B5-dkv
        _check_spec(describe(t, rows), t, rows)
    assert describe(dout, STEP_ROWS).flat() == describe(q, STEP_ROWS).flat()
    assert describe(dq, OUT_ROWS).flat() == describe(q, OUT_ROWS).flat()
    assert describe(dk, OUT_ROWS).flat() == describe(k, OUT_ROWS).flat() == describe(
        dv, OUT_ROWS).flat()
    # a GQA kv head is a head of the (B, KVH, Lk, D) map: its stride steps over
    # Lk rows, not over the query heads
    assert describe(k, TILE_ROWS).strides == (d * 2, lk * d * 2, kvh * lk * d * 2)


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_b5_reads_projection_views_in_place(h, kvh):
    """q and dO as head views of (B, L, H D) projections, k and v of a GQA
    (B, L, 2 KVH D) one, as the model's backward hands them to B5: each is
    described as it is, with the projection's width as its row stride."""
    b, l, d = 2, 4224, 128
    fused_q = _aligned(b, l, 2 * h * d)
    q, dout = (t.view(b, l, h, d).transpose(1, 2) for t in fused_q.split(h * d, dim=-1))
    fused_kv = _aligned(b, l, 2 * kvh * d)
    k, v = (t.view(b, l, kvh, d).transpose(1, 2) for t in fused_kv.split(kvh * d, dim=-1))
    for t, heads, width, rows in ((q, h, 2 * h * d, STEP_ROWS), (dout, h, 2 * h * d, TILE_ROWS),
                                  (k, kvh, 2 * kvh * d, TILE_ROWS),
                                  (v, kvh, 2 * kvh * d, STEP_ROWS)):
        assert tma_operand(t) is t
        spec = describe(t, rows)
        _check_spec(spec, t, rows)
        assert spec.dims == (d, l, heads, b)
        assert spec.strides == (width * 2, d * 2, l * width * 2)


def test_b5_row_statistics_are_copied_in_spans():
    """lse and delta, contiguous fp32 (B, H, Lq), are copied by B5-dkv in
    spans of 64 values (256 bytes): the description gives the extents and
    the span's bytes, as the C entry checks them (`ROWS_SPEC` = 4 values)."""
    lse = _aligned(2, 32, 8192, dtype=torch.float32)
    spec = describe_rows(lse, STEP_ROWS)
    assert spec == RowsSpec((8192, 32, 2), 256)
    assert spec.flat() == [8192, 32, 2, 256]
    assert rows_operand(lse) is lse
    maps = spec_array(describe(_aligned(1, 2, 128, 128), STEP_ROWS), spec)
    assert list(maps)[11:] == [8192, 32, 2, 256]


@pytest.mark.parametrize("make", [
    lambda: _aligned(2 * 4 * 256 + 1, dtype=torch.float32)[1:].view(2, 4, 256),   # 4 bytes off
    lambda: _aligned(2, 256, 4, dtype=torch.float32).transpose(1, 2),             # strided
])
def test_b5_row_statistics_no_span_reads_are_copied(make):
    t = make()
    with pytest.raises(ValueError, match="copy it first"):
        describe_rows(t, STEP_ROWS)
    copied = rows_operand(t)
    assert copied is not t and torch.equal(copied, t)
    assert describe_rows(copied, STEP_ROWS) == RowsSpec((256, 4, 2), 256)


def test_b5_row_statistics_refuse_other_types_and_lengths():
    with pytest.raises(ValueError, match="fp32"):
        describe_rows(_aligned(2, 4, 256), STEP_ROWS)                 # bf16
    with pytest.raises(ValueError, match="tile"):
        describe_rows(_aligned(2, 4, 200, dtype=torch.float32), STEP_ROWS)
    with pytest.raises(ValueError, match="tile"):
        describe_rows(_aligned(2, 4, 256, dtype=torch.float32), 2)    # 8-byte spans


@pytest.mark.parametrize("make", [
    lambda t: t[..., 1:129],                                           # base 2 bytes off
    lambda t: t.as_strided((1, 2, 256, 128), (2 * 256 * 140, 256 * 140, 132, 1)),  # rows 264 B
])
def test_b5_operands_no_map_describes_are_copied(make):
    """A dO or q that TMA cannot read (an odd offset, a row stride of 264
    bytes) is copied, contiguous, before B5 reads it, never sent to another
    path; the copy's maps are the contiguous operand's."""
    base = _aligned(1, 2, 256, 140)
    t = make(base)
    assert not describable(t)
    copied = tma_operand(t)
    assert copied is not t and copied.is_contiguous() and torch.equal(copied, t)
    for rows in (STEP_ROWS, TILE_ROWS):
        _check_spec(describe(copied, rows), copied, rows)


def test_b5_wrappers_leave_cpu_tensors_to_the_plain_versions():
    """On the CPU, B5-dq and B5-dkv compute their plain versions on any
    layout (views no map takes, unaligned statistics), describe nothing and
    count no launch."""
    g = torch.Generator().manual_seed(1)
    b, h, kvh, l, d = 1, 4, 2, 256, 64

    def odd(*shape):   # 2 bytes off: no tensor map describes it
        return torch.randn(*shape[:-1], shape[-1] + 8, generator=g).bfloat16()[..., 1:d + 1]

    q, dout = odd(b, h, l, d), odd(b, h, l, d)
    k, v = odd(b, kvh, l, d), odd(b, kvh, l, d)
    out = long_mod.flash_attention_long(q, k, v)
    delta = fa_mod.attention_delta(out, dout)
    before = [(f.launches, f.bias_launches) for f in (long_mod.attention_bwd_dq_long,
                                                      long_mod.attention_bwd_dkv_long)]
    dq, lse = long_mod.attention_bwd_dq_long(q, k, v, dout, delta)
    stats = torch.empty(2 * lse.numel() + 1)
    lse_odd = stats[1:lse.numel() + 1].view_as(lse).copy_(lse)
    dk, dv = long_mod.attention_bwd_dkv_long(q, k, v, dout, lse_odd, delta)
    after = [(f.launches, f.bias_launches) for f in (long_mod.attention_bwd_dq_long,
                                                     long_mod.attention_bwd_dkv_long)]
    assert after == before
    want_dq, want_lse = long_mod.attention_bwd_dq_long_reference(q, k, v, dout, delta)
    want = long_mod.attention_bwd_dkv_long_reference(q, k, v, dout, want_lse, delta)
    torch.testing.assert_close((dq, lse), (want_dq, want_lse), atol=0, rtol=0)
    torch.testing.assert_close((dk, dv), want, atol=0, rtol=0)

