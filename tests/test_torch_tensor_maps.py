"""The tensor maps through which the wgmma kernels (B1, B2, B3, B3-bias,
B4, B4-bias, B5-dq, B5-dkv; B6) read their operands and write their outputs, as
the wrappers describe them (`mmada_tpu_torch/ops/tensor_maps.py`): dims in
(columns, rows, heads, batches) order, byte strides that are multiples of
16, the box, and a copy of an operand no map can describe; the fp32 bias of
the biased kernels (B2, B4-bias, B5-dq-bias, B5-dkv-bias), broadcast axes as
dimensions of 1, and the grid order it sets; and the spans of fp32 row
statistics (lse, delta) that the dkv kernels (B3's, B5-dkv) read; B6's 2-D
maps of x, the packed int4 weight, its scales and the output, and the tile
height it takes. These run
on the CPU:
the description is Python, and the kernels that take it run on the card
(`tests/test_torch_cuda.py`)."""

import pytest
import torch

from mmada_tpu_torch.models import llada
from mmada_tpu_torch.ops import flash_attention as fa_mod
from mmada_tpu_torch.ops import flash_attention_long as long_mod
from mmada_tpu_torch.ops import int4_matmul as int4_mod
from mmada_tpu_torch.ops.tensor_maps import (
    BIAS_COLS,
    OUT_ROWS,
    STEP_ROWS,
    TILE_ROWS,
    RowsSpec,
    TensorMapSpec,
    aligned_rows,
    bias_describable,
    bias_operand,
    describable,
    describe,
    describe_bias,
    describe_matrix,
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
    """Row statistics are fp32, and a span a multiple of 16 bytes and at
    most 256 values. Any L is described: B3 reads a ragged last span with
    ordinary loads, masked (B5's L is a multiple of the span)."""
    with pytest.raises(ValueError, match="fp32"):
        describe_rows(_aligned(2, 4, 256), STEP_ROWS)                 # bf16
    with pytest.raises(ValueError, match="box"):
        describe_rows(_aligned(2, 4, 256, dtype=torch.float32), 2)    # 8-byte spans
    with pytest.raises(ValueError, match="box"):
        describe_rows(_aligned(2, 4, 1024, dtype=torch.float32), 512)  # past a box
    assert describe_rows(_aligned(2, 4, 200, dtype=torch.float32), STEP_ROWS) == RowsSpec(
        (200, 4, 2), 256)


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



# ---------------------------------------------------------------------- bias

@pytest.mark.parametrize("length", [387, 1155, 8192])
def test_model_bias_is_described_in_place(length):
    """The bias the model builds (`prepare_attention_bias`: (B, 1, L, L) fp32,
    a view of rows padded to 4 floats) at the stage-1, t2i CFG and long
    frames: described as it is, dims (Lk, Lq, 1, B) with the broadcast head
    axis a dimension of 1, the padded row stride, boxes of 32 columns and the
    kernel's rows (B2 and B5-dq-bias 128, B5-dkv-bias 64)."""
    b = 2 if length < 8192 else 1
    mask = torch.ones(b, length, dtype=torch.long)
    mask[0, :17] = 0
    bias = llada.prepare_attention_bias(mask)
    assert bias_describable(bias)
    assert bias_operand(bias) == (bias, False)
    row = -(-length // 4) * 16
    for rows in (TILE_ROWS, STEP_ROWS):
        spec = describe_bias(bias, rows)
        assert spec.dims == (length, length, 1, b)
        assert spec.strides == (row, row * length, row * length)
        assert spec.box == (BIAS_COLS, rows, 1, 1) and BIAS_COLS * 4 == 128
        assert all(x % 16 == 0 for x in spec.strides)
        assert len(spec.flat()) == 11


def test_broadcast_bias_axes_are_dimensions_of_one():
    """A bias broadcast by shape (extent 1) or by an expanded view (stride 0)
    over heads or batches: that axis is a dimension of 1, read at index 0;
    a per-head bias keeps its heads."""
    row = aligned_rows(torch.randn(1, 1, 300, 300))
    for t in (row, row.expand(3, 4, 300, 300), row.expand(3, 1, 300, 300)):
        assert bias_describable(t) and bias_operand(t)[0] is t
        assert describe_bias(t, TILE_ROWS).dims == (300, 300, 1, 1)
    per_head = torch.randn(3, 4, 300, 300)[:, :, :, :]
    spec = describe_bias(per_head, STEP_ROWS)
    assert spec.dims == (300, 300, 4, 3)
    assert spec.strides == (1200, 300 * 1200, 4 * 300 * 1200)


def test_biased_b5_grid_order_follows_the_bias_shape():
    """B5's biased kernels run the heads fastest for a bias broadcast over
    the heads (by extent 1 or by an expanded view), the tiles fastest for a
    per-head bias: the order comes from the bias's tensor map alone."""
    row = aligned_rows(torch.randn(1, 1, 256, 256))
    for t in (row, row.expand(2, 1, 256, 256), row.expand(2, 4, 256, 256),
              torch.randn(2, 1, 256, 256)):
        assert long_mod._heads_fastest(t) == 1
    for t in (torch.randn(2, 4, 256, 256), row.expand(2, 4, 256, 256).contiguous()):
        assert long_mod._heads_fastest(t) == 0


@pytest.mark.parametrize("make", [
    lambda: torch.randn(2, 1, 333, 333),                        # rows 1,332 bytes apart
    lambda: torch.randn(1, 1, 64, 65)[..., 1:],                 # base 4 bytes off
    lambda: torch.randn(1, 3, 64, 64).expand(2, 3, 64, 64)[:, :, :, :].transpose(2, 3),
    lambda: torch.randn(1, 1, 64, 64).double(),                 # not fp32
])
def test_a_bias_no_map_describes_is_copied_once(make):
    """A bias whose rows do not start 16 bytes apart, whose base is not
    aligned or whose columns are strided is copied (`bias_operand`) into
    padded rows, broadcast axes kept at extent 1, with the same values."""
    t = make()
    assert not bias_describable(t)
    with pytest.raises(ValueError, match="copy it first"):
        describe_bias(t, TILE_ROWS)
    if t.dtype != torch.float32:
        return
    copied, was_copied = bias_operand(t)
    assert was_copied and bias_describable(copied)
    assert copied.stride(-2) % 4 == 0 and copied.stride(-1) == 1
    assert copied.shape[0] in (1, t.shape[0]) and copied.shape[1] in (1, t.shape[1])
    torch.testing.assert_close(copied.expand(t.shape), t, atol=0, rtol=0)


# ------------------------------------------------------------------- B3

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("l", [387, 1155])
def test_b3_maps_of_the_one_pass_backward(l, h, kvh, d):
    """The maps B3's wrappers hand its wgmma kernels at the stage-1 and t2i
    frames, ragged lengths: the dq kernel reads q and dO as resident tiles of
    128 rows and k, v as streamed tiles of 64 keys and stores dq 64 rows at a
    time; the dkv kernel reads k and v as resident tiles of 128 rows, q and
    dO as streamed tiles of 64 query rows, stores dk and dv (B, KVH, Lk, D),
    and loads lse and delta in spans of 64 values (256 bytes) of the flat
    (B, H, Lq) arrays. A GQA kv head is a head of the (B, KVH, L, D) maps."""
    b = 2
    q, dout, dq = (_aligned(b, h, l, d) for _ in range(3))
    k, v, dk, dv = (_aligned(b, kvh, l, d) for _ in range(4))
    lse, delta = (_aligned(b, h, l, dtype=torch.float32) for _ in range(2))
    dq_maps = fa_mod._dq_maps(q, k, v, dout, dq)
    for spec, t, rows in zip(dq_maps, (q, k, v, dout, dq),
                             (TILE_ROWS, STEP_ROWS, STEP_ROWS, TILE_ROWS, OUT_ROWS)):
        _check_spec(spec, t, rows)
    dkv_maps = fa_mod._dkv_maps(q, k, v, dout, dk, dv, lse, delta)
    for spec, t, rows in zip(dkv_maps, (q, k, v, dout, dk, dv),
                             (STEP_ROWS, TILE_ROWS, TILE_ROWS, STEP_ROWS, OUT_ROWS, OUT_ROWS)):
        _check_spec(spec, t, rows)
    assert dkv_maps[6:] == [RowsSpec((l, h, b), 256)] * 2
    assert describe(k, TILE_ROWS).strides == (d * 2, l * d * 2, kvh * l * d * 2)
    flat = list(spec_array(*dkv_maps))
    assert len(flat) == 6 * 11 + 2 * 4 and flat[-4:] == [l, h, b, 256]


def test_b3_reads_the_gradient_head_view_in_place():
    """dO as the model's backward hands it to B3: the head view of a (B, L,
    H D) gradient, its row stride the gradient's width, read in place by
    both kernels (a resident tile for dq, a streamed one for dkv)."""
    b, l, h, d = 15, 387, 32, 128
    flat = _aligned(b, l, h * d)
    dout = flat.view(b, l, h, d).transpose(1, 2)
    assert tma_operand(dout) is dout
    for rows in (TILE_ROWS, STEP_ROWS):
        spec = describe(dout, rows)
        _check_spec(spec, dout, rows)
        assert spec.strides == (h * d * 2, d * 2, l * h * d * 2)


def test_b3_copies_an_operand_no_map_describes():
    """A q or dO 2 bytes off (or with rows 264 bytes apart) is copied,
    contiguous, before B3 reads it; the copy's maps are the contiguous
    operand's."""
    base = _aligned(1, 2, 387, 140)
    for t in (base[..., 1:129],
              base.as_strided((1, 2, 387, 128), (2 * 387 * 132, 387 * 132, 132, 1))):
        assert not describable(t)
        copied = tma_operand(t)
        assert copied is not t and copied.is_contiguous() and torch.equal(copied, t)
        for spec, rows in zip(fa_mod._dq_maps(copied, copied, copied, copied, copied),
                              (TILE_ROWS, STEP_ROWS, STEP_ROWS, TILE_ROWS, OUT_ROWS)):
            _check_spec(spec, copied, rows)


def test_b3_row_statistics_at_an_unaligned_lq():
    """lse and delta at the stage-1 batch (15 x 32 heads x 387 rows): a
    (batch, head)'s rows start 1,548 bytes apart, not on 16 bytes, where no
    bulk copy (as B5's aligned lengths allow) may start; they are described
    all the same, and B3 reads them in spans of 64 rows with ordinary loads.
    A base off 16 bytes is copied first (`rows_operand`)."""
    lse = _aligned(15, 32, 387, dtype=torch.float32)
    assert (387 * 4) % 16 != 0
    spec = describe_rows(lse, STEP_ROWS)
    assert spec == RowsSpec((387, 32, 15), 256)
    assert rows_operand(lse) is lse
    stats = _aligned(2 * lse.numel() + 1, dtype=torch.float32)
    odd = stats[1:lse.numel() + 1].view_as(lse)            # 4 bytes off
    with pytest.raises(ValueError, match="copy it first"):
        describe_rows(odd, STEP_ROWS)
    copied = rows_operand(odd)
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, odd)
    assert describe_rows(copied, STEP_ROWS) == spec


# ---------------------------------------------------------------- B4-bias

@pytest.mark.parametrize("d", [64, 128])
def test_b4_bias_maps_of_the_masked_long_forward(d):
    """B4-bias's maps at a masked long frame: q a resident tile of 128 rows,
    k and v streamed tiles of 64 keys (beside the bias tiles), the output
    stored 64 rows at a time, and the model's mask bias ((B, 1, L, L) fp32,
    `prepare_attention_bias`) described in place: dims (L, L, 1, B), boxes of
    32 columns and 128 rows. Broadcast over the heads, it runs the heads
    fastest in the grid; a per-head bias the tiles fastest. B4 (no bias)
    reads k and v in tiles of 128 rows."""
    b, h, l = 2, 2, 4224
    mask = torch.ones(b, l, dtype=torch.long)
    mask[0, :70] = 0
    bias = llada.prepare_attention_bias(mask)
    assert bias_operand(bias) == (bias, False)
    q, out = _aligned(b, h, l, d), _aligned(b, l, h, d).transpose(1, 2)
    k, v = _aligned(b, h, l, d), _aligned(b, h, l, d)
    maps = long_mod._long_fwd_maps(q, k, v, out, bias)
    for spec, t, rows in zip(maps, (q, k, v, out),
                             (TILE_ROWS, STEP_ROWS, STEP_ROWS, OUT_ROWS)):
        _check_spec(spec, t, rows)
    assert maps[4] == describe_bias(bias, TILE_ROWS)
    assert maps[4].dims == (l, l, 1, b) and maps[4].box == (BIAS_COLS, TILE_ROWS, 1, 1)
    assert long_mod._heads_fastest(bias) == 1
    assert long_mod._heads_fastest(bias.expand(b, h, l, l).contiguous()) == 0
    unbiased = long_mod._long_fwd_maps(q, k, v, out)
    assert [m.box[1] for m in unbiased] == [TILE_ROWS, TILE_ROWS, TILE_ROWS, OUT_ROWS]


def test_b3_and_b4_bias_wrappers_leave_cpu_tensors_to_the_plain_versions():
    """On the CPU, B3's dq and dkv and B4-bias compute their plain versions
    on any layout (views no map takes, unaligned statistics, a bias no map
    describes), describe and copy nothing and count no launch."""
    g = torch.Generator().manual_seed(3)
    b, h, kvh, l, d = 1, 4, 2, 131, 64

    def odd(*shape):   # 2 bytes off: no tensor map describes it
        return torch.randn(*shape[:-1], shape[-1] + 8, generator=g).bfloat16()[..., 1:d + 1]

    q, dout = odd(b, h, l, d), odd(b, h, l, d)
    k, v = odd(b, kvh, l, d), odd(b, kvh, l, d)
    out = fa_mod.flash_attention(q, k, v)
    delta = fa_mod.attention_delta(out, dout)
    kernels = (fa_mod.attention_bwd_dq, fa_mod.attention_bwd_dkv, long_mod.flash_attention_long)
    before = [(f.launches, f.bias_launches) for f in kernels]
    copies = long_mod.flash_attention_long.bias_copies
    dq, lse = fa_mod.attention_bwd_dq(q, k, v, dout, delta)
    stats = torch.empty(2 * lse.numel() + 1)
    lse_odd = stats[1:lse.numel() + 1].view_as(lse).copy_(lse)
    dk, dv = fa_mod.attention_bwd_dkv(q, k, v, dout, lse_odd, delta)
    want_dq, want_lse = fa_mod.attention_bwd_dq_reference(q, k, v, dout, delta)
    want = fa_mod.attention_bwd_dkv_reference(q, k, v, dout, want_lse, delta)
    torch.testing.assert_close((dq, lse), (want_dq, want_lse), atol=0, rtol=0)
    torch.testing.assert_close((dk, dv), want, atol=0, rtol=0)
    lb = 256
    q2, k2, v2 = odd(b, h, lb, d), odd(b, kvh, lb, d), odd(b, kvh, lb, d)
    bias = torch.randn(2, 1, lb, lb + 3, generator=g)[..., 3:]   # base 12 bytes off
    assert not bias_describable(bias)
    got = long_mod.flash_attention_long(q2, k2, v2, bias)
    torch.testing.assert_close(got, long_mod.flash_attention_long_reference(q2, k2, v2, bias),
                               atol=0, rtol=0)
    assert [(f.launches, f.bias_launches) for f in kernels] == before
    assert long_mod.flash_attention_long.bias_copies == copies


# --------------------------------------------------------------------- B6

H100_SMS = 132


def _int4_operands(m, k, n):
    x = _aligned(m, k)
    packed = torch.zeros(k // 2, n, dtype=torch.int8)
    scales = _aligned(k // 128, n, dtype=torch.float32)
    out = torch.empty(m, n, dtype=torch.bfloat16)
    return x, packed, scales, out


@pytest.mark.parametrize("m,k,n,rows", [
    (477, 4096, 4096, 128), (477, 4096, 12288, 256), (477, 12288, 4096, 128),
    (96, 4096, 134656, 128), (4620, 4096, 12288, 256), (4620, 4096, 4096, 256),
    (4620, 12288, 4096, 256), (4096, 4096, 8192, 256), (1, 4096, 4096, 128),
])
def test_b6_maps_of_the_int4_matmul(m, k, n, rows):
    """B6's maps at the int4 8B's main-path shapes: x (M, K) bf16 as (K, M,
    1, 1) in boxes of 64 columns (the 128-byte swizzle) and the tile's rows,
    the packed int8 weight (K/2, N) in boxes of 128 x 64 bytes (one group),
    the fp32 scales (K/128, N) in boxes of 128 x 1, the bf16 output (M, N)
    in boxes of 64 x 64; every stride the tensor's own row, in bytes. Tall
    tiles (256 rows) where their fewer waves pay: the t2i batch, and the
    text batch's ff_proj (two waves of 256-row tiles, not three of 128),
    not its shapes of one wave at either height or the head's 96 rows."""
    x, packed, scales, out = _int4_operands(m, k, n)
    assert int4_mod.block_rows(m, n, H100_SMS) == rows
    maps = int4_mod.int4_maps(x, packed, scales, out, H100_SMS)
    want = [((k, m, 1, 1), 2 * k, (64, rows, 1, 1)),
            ((n, k // 2, 1, 1), n, (128, 64, 1, 1)),
            ((n, k // 128, 1, 1), 4 * n, (128, 1, 1, 1)),
            ((n, m, 1, 1), 2 * n, (64, 64, 1, 1))]
    for spec, (dims, row_bytes, box) in zip(maps, want):
        assert spec.dims == dims and spec.box == box
        assert spec.strides[0] == row_bytes and all(st % 16 == 0 for st in spec.strides)
        assert len(spec.flat()) == 11


def test_b6_reads_a_column_window_and_a_layer_in_place():
    """The t2i head's image ids as a column window `packed[:, lo:hi]` of the
    packed head, and one layer `packed[i]` of a stacked weight: maps of the
    views themselves (base at the window or the layer, the parent's row
    stride), no copy."""
    lo, hi = 256, 768
    packed = torch.zeros(64, 1024, dtype=torch.int8)
    scales = _aligned(1, 1024, dtype=torch.float32)
    win_p, win_s = packed[:, lo:hi], scales[:, lo:hi]
    spec = describe_matrix(win_p, 128, 64)
    assert spec.dims == (hi - lo, 64, 1, 1) and spec.strides[0] == 1024
    assert describe_matrix(win_s, 128, 1).dims == (hi - lo, 1, 1, 1)
    assert win_p.data_ptr() - packed.data_ptr() == lo
    stacked = torch.zeros(3, 128, 256, dtype=torch.int8)
    layer = stacked[1]
    spec = describe_matrix(layer, 128, 64)
    assert spec.dims == (256, 128, 1, 1) and spec.strides[0] == 256
    assert layer.data_ptr() - stacked.data_ptr() == 128 * 256


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(64, 1024, dtype=torch.int8)[:, 8:136],       # base 8 bytes off
    lambda: torch.zeros(64, 1032, dtype=torch.int8)[:, :128],        # rows 1,032 bytes apart
    lambda: torch.zeros(10, 129, dtype=torch.bfloat16)[:, :128],     # rows 258 bytes apart
    lambda: torch.zeros(128, 64, dtype=torch.bfloat16).t(),          # strided columns
    lambda: torch.zeros(2, 64, 128, dtype=torch.bfloat16),           # not 2-D
])
def test_b6_refuses_a_view_no_map_describes(make):
    """A view whose base or row stride is not a multiple of 16 bytes, whose
    columns are strided, or that is not 2-D, has no 2-D map: refused (the
    wrapper's checks raise first on the card). A row stride of 1,032 bytes
    is a multiple of 8 but not of 16: refused too."""
    t = make()
    with pytest.raises(ValueError, match="no tensor map describes|2-D"):
        describe_matrix(t, 64, 64)
