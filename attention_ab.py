#!/usr/bin/env python3
"""Times the attention kernels B1, B2, B4 and B4-bias (the forwards), B3 and
B3-bias (the one-pass backward), B5 (the long training path's staged
backward, unbiased and biased), B7 and B8 (the forward and the backward at
fp32 and at bf16 widths other than 64 and 128) and the int4 matmul B6
against those of another checkout of the port, in turns on one NVIDIA GPU.

    python3 attention_ab.py PARENT_DIR [--out chiprun_out/attention_ab.json]
                            [--only forward|backward|int4|b7|b8]

PARENT_DIR is an unpacked checkout of the commit to compare with (for
example `git archive HEAD | tar -x -C chip_checkout`) whose B1-B6 take
tensor maps, as here, and run through this checkout's wrappers with its own
C entries (`_through`), and whose B7 has a tensor-core body for bf16 up to
D 256 behind `mmada_attention_wide_fwd_bf16` (run through this checkout's
wrappers: the same maps) and a CUDA-core body for fp32 and wider bf16
behind `mmada_attention_generic_fwd` (PR 24's signature: q and k rotated
first), called with the arguments its own wrapper passed (`parent_b7`),
and whose B8 is a single CUDA-core kernel a
tier behind `mmada_attention_generic_dq` / `_dkv` (`parent_b8`, the
arguments its wrappers passed). Its kernels are built from its own
`mmada_tpu_torch/ops/csrc` with its own `_build.py`. This checkout's
kernels run through its wrappers. Each measurement runs in the order parent, this, this, parent, on
the same inputs:

  * B1 at the t2i CFG batch (4 x 32 heads x 1,155 tokens, RoPE) and at the
    served text batch (3 x 32 x 159, RoPE), B2 at the t2i CFG batch with the
    served requests' mask bias, B4 at the long text frame (1 x 32 x 8,192),
    B4-bias at the long training batch (2 x 32 x 8,192) with its masks:
    CUDA events, 10 calls after 2 warm-up, and the device time of the
    kernels a call launches (torch.profiler, 10 calls: it leaves out the
    time the stream waits for the host); beside them, the share of their
    output elements that differ from the plain version's
    (`flash_attention_reference`), for B2 the bias bytes its blocks read
    against its device time, and for B4-bias the largest difference of its
    output from the parent's;
  * one forward of the full-width 8B (random weights from seed 0, bf16) at
    the served text batch (3 x 159 tokens, the head over one 32-token block),
    at the t2i CFG batch (the sampler's first forward, windowed head),
    without and with its attention masks (`attention_bias_enabled`), and on
    the 8,192-token text frame (the head over one 64-token block), with the
    model's attention calls sent to one version's kernels or the other's:
    CUDA events, 3 calls after 1 warm-up, and the device time of the
    kernels a forward launches (3 forwards);
  * B3's dq and dkv at the stage-1 training batch (15 x 32 heads x 387
    tokens), unbiased and with the batch's masks (B3-bias, the cotangent 0
    on the rows with no allowed key), B5-dq and B5-dkv at the long training
    batch (2 x 32 heads x 8,192 tokens) and at 16,384 tokens (1 x 2 heads),
    and B5-dq-bias and B5-dkv-bias at the long training batch with its
    masks: CUDA events, 10 calls after 2 warm-up, and the device time of a
    call; beside them the largest difference of each output from the
    parent's, relative to the parent's largest entry (lse: absolute);
  * B6 at the int4 8B's main-path shapes (`chip_smoke.int4_cases`, the
    first eight: the served text batch's and the t2i CFG batch's matmuls
    and heads): CUDA events, 10 calls after 2 warm-up, and the device time
    of a call; beside them the bound (`chip_smoke.int4_bound`), the largest
    difference of the output from the parent's, in bf16 ulps of the larger
    entry, and whether the two are equal bit for bit; then B6-f32 (fp32 x)
    at `chip_smoke.INT4_F32_CASES`, the parent's through its own C entry
    `mmada_int4_matmul_f32` with the arguments its wrapper passed
    (`parent_b6_f32`), with the fp32 bound and the largest difference from
    the parent's relative to its largest entry.

  * B7 at the four shapes PERF.md tracks (the t2i CFG frame, 4 x 1,155
    tokens with RoPE, in bf16 at D 256 with 16 heads and in fp32 at D 128
    with 32; the long tier at 1 x 16 x 8,192 tokens in bf16 at D 256 and
    fp32 at D 128): CUDA events (10 calls after 2 warm-up; 3 after 1 on
    the long tier) and device time, with the largest difference of the
    output from the parent's (absolute and relative to its largest entry),
    whether the two are equal bit for bit, and which body this checkout
    took (`flash_attention.generic_body`); then bf16 D 512 (the rectangular
    biased case of 1 x 4 heads x 200 x 500 keys, the t2i CFG frame and the
    long tier with 8 heads), the parent's through its CUDA-core body; then
    the wgmma instances of 64, 128 and 256 (D 48, 96, 192, one-pass with a
    mask and long), the parent's `mmada_attention_wide_fwd_bf16` through
    this checkout's wrappers, held bit for bit; beside them B1 and B2 at the
    t2i CFG frame and B4 at the long text frame (D 128), each output held
    against the parent's bit for bit;
  * B8-dq and B8-dkv at the same four shapes (the one-pass tier at the t2i
    CFG frame, the long tier at 8,192 tokens; q and k unrotated, delta from
    this checkout's forward, dkv fed this checkout's lse): CUDA events and
    device time as B7's, the largest difference of each output (dq, lse; dk,
    dv) from the parent's, and the body this checkout took.

`--only forward` runs the first two, `--only backward` the third, `--only
int4` the fourth, `--only b7` the fifth, `--only b8` the last.

Prints one JSON line per measurement, the card's name and power limit as
nvidia-smi reports them, and a summary JSON line last; with --out, writes
all of it there too. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import chip_smoke


def parent_kernels(parent_dir: str) -> dict:
    """The kernels of the checkout at `parent_dir` (B1-B6 taking tensor
    maps), as callables with the signatures of this checkout's wrappers:
    "forward" (`flash_attention`: B1, or B2 with a bias), "long" (B4, or
    B4-bias with a bias), "dq" and "dkv" (B3's, or B3-bias's with a bias),
    "long_dq" and "long_dkv" (B5's, with an optional bias), "int4" (B6), all
    through this checkout's wrappers (`_through`); "int4_f32" (the parent's
    B6-f32 through its own entry: `parent_b6_f32`); "wide" (the parent's
    B7 wgmma body through this checkout's one-pass and long wrappers); "b7"
    (the parent's B7 CUDA-core body, through its own entry: `parent_b7`)."""
    import torch

    from mmada_tpu_torch.ops import flash_attention as fa
    from mmada_tpu_torch.ops import flash_attention_long as long_mod
    from mmada_tpu_torch.ops import int4_matmul as int4_mod

    path = os.path.join(parent_dir, "mmada_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build_all(["flash_attention_fwd", "flash_attention_bwd", "flash_attention_long",
                     "int4_matmul", "int4_matmul_f32", "attention_generic", "attention_wide"])
    p, i = ctypes.c_void_p, ctypes.c_int

    def entry(source, name, n_ptr, lists):
        fn = getattr(build.load_library(source), name)
        fn.argtypes = [p] * n_ptr + [i] * 6 + lists + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        return fn

    def through(wrapper, source, name, n_ptr, arrays=1):
        return _through(wrapper, name, entry(source, name, n_ptr, [p] * arrays))

    b1 = through(fa.flash_attention, "flash_attention_fwd", "mmada_flash_attention_fwd_bf16", 8,
                 arrays=2)
    b2 = through(fa.flash_attention, "flash_attention_fwd",
                 "mmada_flash_attention_fwd_bias_bf16", 9, arrays=2)
    b4 = through(long_mod.flash_attention_long, "flash_attention_long",
                 "mmada_flash_attention_long_fwd_bf16", 4)
    long_dq = {bias: through(long_mod.attention_bwd_dq_long, "flash_attention_long",
                             f"mmada_flash_attention_long_bwd_dq{bias}_bf16", 7 + bool(bias))
               for bias in ("", "_bias")}
    long_dkv = {bias: through(long_mod.attention_bwd_dkv_long, "flash_attention_long",
                              f"mmada_flash_attention_long_bwd_dkv{bias}_bf16", 8 + bool(bias))
                for bias in ("", "_bias")}
    b4_bias = through(long_mod.flash_attention_long, "flash_attention_long",
                      "mmada_flash_attention_long_fwd_bias_bf16", 5)
    b3_dq = {bias: through(fa.attention_bwd_dq, "flash_attention_bwd",
                           f"mmada_flash_attention_bwd_dq{bias}_bf16", 7 + bool(bias))
             for bias in ("", "_bias")}
    b3_dkv = {bias: through(fa.attention_bwd_dkv, "flash_attention_bwd",
                            f"mmada_flash_attention_bwd_dkv{bias}_bf16", 8 + bool(bias))
              for bias in ("", "_bias")}
    wide_fn = getattr(build.load_library("attention_wide"), "mmada_attention_wide_fwd_bf16")
    wide_fn.argtypes = [p] * 5 + [i] * 7 + [p, ctypes.c_float, p]
    wide_fn.restype = ctypes.c_int
    wide = {"one_pass": _through(fa.flash_attention, "mmada_attention_wide_fwd_bf16", wide_fn),
            "long": _through(long_mod.flash_attention_long, "mmada_attention_wide_fwd_bf16",
                             wide_fn)}
    b7 = getattr(build.load_library("attention_generic"), "mmada_attention_generic_fwd")
    b7.argtypes = [p] * 5 + [i] * 8 + [p, ctypes.c_float, p]
    b7.restype = ctypes.c_int
    b8 = {name: getattr(build.load_library("attention_generic"), f"mmada_attention_generic_{name}")
          for name in ("dq", "dkv")}
    b8["dq"].argtypes = [p] * 8 + [i] * 8 + [p, ctypes.c_float, p]
    b8["dkv"].argtypes = [p] * 9 + [i] * 7 + [p, ctypes.c_float, p]
    for fn in b8.values():
        fn.restype = ctypes.c_int

    def forward(q, k, v, rope_sin=None, rope_cos=None, bias=None):
        call = b1 if bias is None else b2
        return call(q, k, v, rope_sin=rope_sin, rope_cos=rope_cos, bias=bias)

    def long_forward(q, k, v, bias=None):
        return b4(q, k, v) if bias is None else b4_bias(q, k, v, bias)

    def dq(q, k, v, dout, delta, bias=None):
        return b3_dq["" if bias is None else "_bias"](q, k, v, dout, delta, bias)

    def dkv(q, k, v, dout, lse, delta, bias=None):
        return b3_dkv["" if bias is None else "_bias"](q, k, v, dout, lse, delta, bias)

    b6 = getattr(build.load_library("int4_matmul"), "mmada_int4_matmul_bf16")
    b6.argtypes = [p] * 4 + [i] * 3 + [p, p]
    b6.restype = ctypes.c_int

    def int4(x, packed, scales):
        own = int4_mod._fn
        int4_mod._fn = b6
        try:
            return int4_mod.int4_matmul(x, packed, scales)
        finally:
            int4_mod._fn = own

    b6_f32 = getattr(build.load_library("int4_matmul_f32"), "mmada_int4_matmul_f32")
    ll = ctypes.c_longlong
    b6_f32.argtypes = [p, ll, p, ll, p, ll, p, i, i, i, p]
    b6_f32.restype = ctypes.c_int

    def b5_dq(q, k, v, dout, delta, bias=None):
        return long_dq["" if bias is None else "_bias"](q, k, v, dout, delta, bias)

    def b5_dkv(q, k, v, dout, lse, delta, bias=None):
        return long_dkv["" if bias is None else "_bias"](q, k, v, dout, lse, delta, bias)

    return {"forward": forward, "long": long_forward, "dq": dq, "dkv": dkv,
            "long_dq": b5_dq, "long_dkv": b5_dkv, "int4": int4,
            "int4_f32": lambda *a: parent_b6_f32(b6_f32, *a), "wide": wide,
            "b7": lambda *a, **kw: parent_b7(b7, wide, *a, **kw),
            "b8": lambda *a, **kw: parent_b8(b8, *a, **kw)}


def parent_b7(fn, wide, q, k, v, rope_sin=None, rope_cos=None, bias=None, long_tier=False):
    """The parent's B7 as its wrapper called it: bf16 up to D 256 through its
    wgmma body (`wide`: its entry in this checkout's wrappers), else through
    its C entry `fn` (`mmada_attention_generic_fwd`): q and k rotated first
    at the real width by the rotation kernel (`flash_attention._rotated`,
    the same kernel in both checkouts), operands a tensor map could
    describe, by element strides, the output written as (B, Lq, H, D)."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import _dtype_code, _rotated, _strides
    from mmada_tpu_torch.ops.tensor_maps import tma_operand

    if q.dtype == torch.bfloat16 and q.shape[-1] <= 256:
        if long_tier:
            return wide["long"](q, k, v, bias)
        return wide["one_pass"](q, k, v, rope_sin=rope_sin, rope_cos=rope_cos, bias=bias)
    if rope_sin is not None:
        q, k = _rotated(q, rope_sin, rope_cos), _rotated(k, rope_sin, rope_cos)
    q, k, v = (tma_operand(t) for t in (q, k, v))
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    ptrs = [None if t is None else t.data_ptr() for t in (q, k, v, out, bias)]
    strides = _strides(q, k, v, out, bias)
    err = fn(*ptrs, _dtype_code(q), int(long_tier), b, h, kvh, lq, lk, d,
             strides.buffer_info()[0], 1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent mmada_attention_generic_fwd failed: cudaError {err}")
    return out


def parent_b6_f32(fn, x, packed, scales):
    """The parent's B6-f32 through its C entry `fn` (`mmada_int4_matmul_f32`:
    one launch, no split of K), with the arguments its wrapper passed: x
    (M, K) fp32 by its row stride, the packed weight and the scales by
    theirs, the fp32 output (M, N)."""
    import torch

    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), x.stride(0), packed.data_ptr(), packed.stride(0), scales.data_ptr(),
             scales.stride(0), out.data_ptr(), m, k, n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent mmada_int4_matmul_f32 failed: cudaError {err}")
    return out


def parent_b8(fns, q, k, v, dout, delta, lse=None, long_tier=False):
    """The parent's B8 through its C entries `fns` ("dq":
    `mmada_attention_generic_dq`, "dkv": `..._dkv`), on operands with a
    contiguous last dim by element strides, as its wrapper passed them:
    (dq, lse) without `lse`, else (dk, dv)."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import _dtype_code, _strides

    q, k, v, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, dout))
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    if lse is None:
        dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        ptrs = [t.data_ptr() for t in (q, k, v, dout, delta)] + [None, dq.data_ptr(),
                                                                 lse.data_ptr()]
        strides = _strides(q, k, v, dout, dq, None)
        err = fns["dq"](*ptrs, _dtype_code(q), int(long_tier), b, h, kvh, lq, lk, d,
                        strides.buffer_info()[0], 1.0 / d ** 0.5, stream)
        out = (dq, lse)
    else:
        dk = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
        dv = torch.empty_like(dk)
        ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta)] + [None, dk.data_ptr(),
                                                                      dv.data_ptr()]
        strides = _strides(q, k, v, dout, dk, dv, None)
        err = fns["dkv"](*ptrs, _dtype_code(q), b, h, kvh, lq, lk, d, strides.buffer_info()[0],
                         1.0 / d ** 0.5, stream)
        out = (dk, dv)
    if err:
        raise RuntimeError(f"parent B8 failed: cudaError {err}")
    return out


def _through(wrapper, name: str, fn):
    """`wrapper` with the C entry `fn` launched in place of its own entry
    `name` (the same signature)."""
    from mmada_tpu_torch.ops import flash_attention as fa

    def call(*args, **kw):
        own = fa._fns.get(name)
        fa._fns[name] = fn
        try:
            return wrapper(*args, **kw)
        finally:
            if own is None:
                fa._fns.pop(name)
            else:
                fa._fns[name] = own

    return call


def in_turns(fns: dict, measure) -> dict:
    """measure(fn) in the order first, second, second, first of the two
    versions in `fns` (parent, this, this, parent); every value and the mean
    per version."""
    first, second = fns
    order = [first, second, second, first]
    values = {name: [] for name in fns}
    for name in order:
        values[name].append(measure(fns[name]))
    return {name: dict(values=v, mean=sum(v) / len(v)) for name, v in values.items()}


def differing_share(got, want) -> float:
    return float((got != want).float().mean())


def device_ms(fn, iters: int = 10) -> float:
    """The device time of one call of `fn` in ms: the summed time of the
    kernels it launches (torch.profiler), over `iters` calls after one
    warm-up. Unlike CUDA events around the calls, it leaves out the time
    the stream waits for the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


def relative_gap(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def time_b3(b3: dict, emit) -> None:
    """B3's dq and dkv of both versions at the stage-1 training batch, and
    B3-bias's with the batch's masks (the cotangent 0 on the rows with no
    allowed key), in turns, on the same inputs."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import attention_delta, flash_attention

    b, h, l = chip_smoke.TRAIN_ROWS, 32, chip_smoke.TRAIN_FRAME
    for masked in (False, True):
        q, k, v, _, _ = chip_smoke.attention_case(b, h, h, l, l, False, seed=15)
        bias = chip_smoke.train_mask_bias() if masked else None
        dout = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(16),
                           device="cuda").to(torch.bfloat16)
        if masked:
            dout = dout * chip_smoke.live_rows(bias, dout.shape)
        delta = attention_delta(flash_attention(q, k, v, bias=bias), dout)
        outs = {name: fns[0](q, k, v, dout, delta, bias) for name, fns in b3.items()}
        lse = outs["parent"][1]
        grads = {name: fns[1](q, k, v, dout, lse, delta, bias) for name, fns in b3.items()}
        gap = {"dq": relative_gap(outs["this"][0], outs["parent"][0]),
               "lse_abs": float((outs["this"][1] - lse).abs().max()),
               "dk": relative_gap(grads["this"][0], grads["parent"][0]),
               "dv": relative_gap(grads["this"][1], grads["parent"][1])}
        suffix = "-bias" if masked else ""
        calls = ((f"B3-dq{suffix}", lambda fns: fns[0](q, k, v, dout, delta, bias)),
                 (f"B3-dkv{suffix}", lambda fns: fns[1](q, k, v, dout, lse, delta, bias)))
        for kernel, call in calls:
            times = in_turns(b3, lambda fns: chip_smoke.cuda_ms(lambda: call(fns), 10))
            device = in_turns(b3, lambda fns: device_ms(lambda: call(fns)))
            emit(dict(tag=f"{kernel} stage-1{' + mask' if masked else ''}",
                      shape=[b, h, h, l, l], ms=times, device_ms=device, gap_to_parent=gap))
        del q, k, v, dout, delta, outs, grads, lse, bias
        torch.cuda.empty_cache()


def time_b6(b6: dict, emit) -> None:
    """B6 of both versions at the int4 8B's main-path shapes, in turns, on the
    same operands (`chip_smoke.int4_operands`)."""
    import torch

    from mmada_tpu_torch.models import llada

    for i, (tag, m, k, n, view) in enumerate(chip_smoke.int4_cases(llada.llada_8b())[:8]):
        x, packed, scales = chip_smoke.int4_operands(m, k, n, view, seed=900 + i)
        outs = {name: fn(x, packed, scales) for name, fn in b6.items()}
        got, want = outs["this"].float(), outs["parent"].float()
        _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
        ulps = float(((got - want).abs() / torch.ldexp(torch.ones_like(got), exp - 8)).max())
        times = in_turns(b6, lambda fn: chip_smoke.cuda_ms(lambda: fn(x, packed, scales), 10))
        device = in_turns(b6, lambda fn: device_ms(lambda: fn(x, packed, scales)))
        bound_ms, bound_by = chip_smoke.int4_bound(m, k, n)
        emit(dict(tag=f"B6 {tag}", shape=[m, k, n], ms=times, device_ms=device,
                  bound_ms=bound_ms, bound_by=bound_by, ulps_from_parent=ulps,
                  same_as_parent=bool(torch.equal(outs["this"], outs["parent"]))))
        del x, packed, scales, outs, got, want
        torch.cuda.empty_cache()


def time_b5(b5: dict, emit) -> None:
    """B5-dq and B5-dkv of both versions at the long training batch and at
    16,384 tokens, and B5-dq-bias and B5-dkv-bias at the long training batch
    with its masks, in turns, on the same inputs."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import attention_delta
    from mmada_tpu_torch.ops.flash_attention_long import flash_attention_long

    rows, frame = chip_smoke.LONG_TRAIN_ROWS, chip_smoke.LONG_FRAME
    for tag, (b, h, l), masked in (("long train", (rows, 32, frame), False),
                                   ("L16384, 2 heads", (1, 2, 16384), False),
                                   ("long train + mask", (rows, 32, frame), True)):
        q, k, v, _, _ = chip_smoke.attention_case(b, h, h, l, l, False, seed=13)
        bias = chip_smoke.train_mask_bias(chip_smoke.LONG) if masked else None
        g = torch.Generator("cuda").manual_seed(14)
        dout = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
        if masked:  # the model's cotangent: 0 on the rows with no allowed key
            dout = dout * chip_smoke.live_rows(bias, dout.shape)
        delta = attention_delta(flash_attention_long(q, k, v, bias), dout)
        outs = {name: fns[0](q, k, v, dout, delta, bias) for name, fns in b5.items()}
        lse = outs["parent"][1]
        grads = {name: fns[1](q, k, v, dout, lse, delta, bias) for name, fns in b5.items()}
        gap = {"dq": relative_gap(outs["this"][0], outs["parent"][0]),
               "lse_abs": float((outs["this"][1] - lse).abs().max()),
               "dk": relative_gap(grads["this"][0], grads["parent"][0]),
               "dv": relative_gap(grads["this"][1], grads["parent"][1])}
        suffix = "-bias" if masked else ""
        calls = ((f"B5-dq{suffix}", lambda fns: fns[0](q, k, v, dout, delta, bias)),
                 (f"B5-dkv{suffix}", lambda fns: fns[1](q, k, v, dout, lse, delta, bias)))
        for kernel, call in calls:
            times = in_turns(b5, lambda fns: chip_smoke.cuda_ms(lambda: call(fns), 10))
            device = in_turns(b5, lambda fns: device_ms(lambda: call(fns)))
            emit(dict(tag=f"{kernel} {tag}", shape=[b, h, h, l, l], ms=times, device_ms=device,
                      gap_to_parent=gap))
        del q, k, v, dout, delta, outs, grads, lse, bias
        torch.cuda.empty_cache()


def time_b4_bias(b4: dict, emit) -> None:
    """B4-bias of both versions at the long training batch with its masks,
    in turns, on the same inputs."""
    import torch

    b, h, l = chip_smoke.LONG_TRAIN_ROWS, 32, chip_smoke.LONG_FRAME
    q, k, v, _, _ = chip_smoke.attention_case(b, h, h, l, l, False, seed=17)
    bias = chip_smoke.train_mask_bias(chip_smoke.LONG)
    outs = {name: fn(q, k, v, bias) for name, fn in b4.items()}
    times = in_turns(b4, lambda fn: chip_smoke.cuda_ms(lambda: fn(q, k, v, bias), 10))
    device = in_turns(b4, lambda fn: device_ms(lambda: fn(q, k, v, bias)))
    emit(dict(tag="B4-bias long train + mask", shape=[b, h, h, l, l], ms=times,
              device_ms=device, gap_to_parent=relative_gap(outs["this"], outs["parent"])))
    del q, k, v, bias, outs
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=("forward", "backward", "int4", "b7", "b8"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2

    from mmada_tpu_torch.ops import _build
    from mmada_tpu_torch.ops.flash_attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention,
    )
    from mmada_tpu_torch.ops.flash_attention_long import (
        attention_bwd_dkv_long,
        attention_bwd_dq_long,
        flash_attention_long,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    from mmada_tpu_torch.ops.int4_matmul import int4_matmul

    _build.build_all()
    parent = parent_kernels(args.parent_dir)
    b1 = {"parent": parent["forward"], "this": flash_attention}
    b4 = {"parent": parent["long"], "this": flash_attention_long}
    b3 = {"parent": (parent["dq"], parent["dkv"]), "this": (attention_bwd_dq, attention_bwd_dkv)}
    b5 = {"parent": (parent["long_dq"], parent["long_dkv"]),
          "this": (attention_bwd_dq_long, attention_bwd_dkv_long)}
    if args.only in (None, "backward"):
        time_b3(b3, emit)
        time_b5(b5, emit)
    if args.only in (None, "forward"):
        time_b4_bias(b4, emit)
    if args.only in (None, "forward", "b7"):
        time_forward_kernels(b1, b4, emit)
    if args.only in (None, "forward"):
        time_model_forwards(b1, b4, emit)
    if args.only in (None, "int4"):
        time_b6({"parent": parent["int4"], "this": int4_matmul}, emit)
        time_b6_f32({"parent": parent["int4_f32"], "this": int4_matmul}, emit)
    if args.only in (None, "b7"):
        time_b7({"parent": parent["b7"], "this": (flash_attention, flash_attention_long)}, emit)
        time_wide_instances(dict(parent["wide"], this=flash_attention), emit)
    if args.only in (None, "b8"):
        time_b8(parent["b8"], emit)
    print(smi, flush=True)
    summary = {r["tag"]: {name: t["mean"] for name, t in r["ms"].items()} for r in records}
    print(json.dumps({"card": smi, "mean_ms": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "mean_ms": summary}, f, indent=1)
    return 0


def time_b7(b7: dict, emit) -> None:
    """B7 of both versions at PERF.md's shapes (the four of PRs 23-25, then
    bf16 D 512: the rectangular biased case, the t2i CFG frame with 8 heads,
    the long frame), in turns, on the same inputs, with this checkout's body
    (`generic_body`), the largest difference of its output from the
    parent's and whether the two are equal bit for bit."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import generic_body

    t2i, long_l = chip_smoke.T2I_FRAME, chip_smoke.LONG_FRAME
    heads = chip_smoke.WIDER_HEADS
    for tag, dtype, (b, h, lq, lk), d, long, bias in (
            ("B7 t2i CFG bf16 D256", torch.bfloat16, (4, 16, t2i, t2i), 256, False, None),
            ("B7 t2i CFG fp32 D128", torch.float32, (4, 32, t2i, t2i), 128, False, None),
            ("B7-long bf16 D256", torch.bfloat16, (1, 16, long_l, long_l), 256, True, None),
            ("B7-long fp32 D128", torch.float32, (1, 16, long_l, long_l), 128, True, None),
            ("B7 bf16 D512 rectangular + bias", torch.bfloat16, (1, 4, 200, 500), 512, False,
             lambda: chip_smoke.random_bias(1, 4, 200, 500, 12)),
            ("B7 t2i CFG bf16 D512", torch.bfloat16, (4, heads, t2i, t2i), 512, False, None),
            ("B7-long bf16 D512", torch.bfloat16, (1, heads, long_l, long_l), 512, True, None)):
        rope = not long and lq == lk
        q, k, v, sin, cos = chip_smoke.generic_case(dtype, b, h, h, lq, lk, d, rope, seed=21)
        kw = {"long_tier": True} if long else {"rope_sin": sin, "rope_cos": cos}
        if bias is not None:
            kw["bias"] = bias()
        this = b7["this"][long]
        fns = {"parent": lambda: b7["parent"](q, k, v, **kw),
               "this": lambda: this(q, k, v) if long else this(q, k, v, **kw)}
        outs = {name: fn() for name, fn in fns.items()}
        gap = float((outs["this"].float() - outs["parent"].float()).abs().max())
        iters, warm = (3, 1) if long else (10, 2)
        times = in_turns(fns, lambda fn: chip_smoke.cuda_ms(fn, iters, warm))
        device = in_turns(fns, lambda fn: device_ms(fn, iters))
        emit(dict(tag=tag, shape=[b, h, h, lq, lk], d=d, body=generic_body(dtype, d), ms=times,
                  device_ms=device, gap_to_parent=dict(
                      abs=gap, rel=relative_gap(outs["this"], outs["parent"])),
                  same_as_parent=bool(torch.equal(outs["this"], outs["parent"]))))
        del q, k, v, outs, kw
        torch.cuda.empty_cache()


def time_wide_instances(wide: dict, emit) -> None:
    """B7's wgmma instances of 64, 128 and 256 columns (bf16 D 48, 96, 192)
    of both versions, the parent's through its own C entry and this
    checkout's wrappers: the one-pass tier with RoPE and the served mask
    bias (2 x 8 heads x 387 tokens), the long tier at 4,224 tokens; each
    output held against the parent's bit for bit, with the times."""
    import torch

    from mmada_tpu_torch.ops.flash_attention_long import flash_attention_long

    for d in (48, 96, 192):
        for long in (False, True):
            l = 4224 if long else 387
            b = 1 if long else 2
            q, k, v, sin, cos = chip_smoke.generic_case(torch.bfloat16, b, 8, 8, l, l, d,
                                                        not long, seed=23)
            if long:
                fns = {name: (lambda fn=fn: fn(q, k, v)) for name, fn in (
                    ("parent", wide["long"]), ("this", flash_attention_long))}
            else:
                bias = chip_smoke.padded_rows_bias(b, l)
                fns = {name: (lambda fn=fn: fn(q, k, v, rope_sin=sin, rope_cos=cos, bias=bias))
                       for name, fn in (("parent", wide["one_pass"]), ("this", wide["this"]))}
            outs = {name: fn() for name, fn in fns.items()}
            emit(dict(tag=f"B7 wgmma instance bf16 D{d}{' long' if long else ' + mask'}",
                      shape=[b, 8, 8, l, l], d=d,
                      ms=in_turns(fns, lambda fn: chip_smoke.cuda_ms(fn, 10)),
                      same_as_parent=bool(torch.equal(outs["this"], outs["parent"]))))
            del q, k, v, outs
            torch.cuda.empty_cache()


def time_b6_f32(b6: dict, emit) -> None:
    """B6-f32 of both versions at its two cases (`chip_smoke.INT4_F32_CASES`),
    in turns, on the same operands, with the bound and the largest
    difference of the output from the parent's relative to its largest
    entry."""
    import torch

    for i, (tag, m, k, n) in enumerate(chip_smoke.INT4_F32_CASES):
        x, packed, scales = chip_smoke.int4_f32_operands(m, k, n, seed=1800 + i)
        outs = {name: fn(x, packed, scales) for name, fn in b6.items()}
        times = in_turns(b6, lambda fn: chip_smoke.cuda_ms(lambda: fn(x, packed, scales), 10))
        device = in_turns(b6, lambda fn: device_ms(lambda: fn(x, packed, scales)))
        bound_ms, bound_by = chip_smoke.bound(
            2 * m * k * n, 4 * m * k + k * n // 2 + 4 * (k // 128) * n + 4 * m * n,
            chip_smoke.PEAK_FP32_FLOPS)
        emit(dict(tag=f"B6-f32 {tag}", shape=[m, k, n], ms=times, device_ms=device,
                  bound_ms=bound_ms, bound_by=bound_by,
                  gap_to_parent=relative_gap(outs["this"], outs["parent"])))
        del x, packed, scales, outs
        torch.cuda.empty_cache()


def time_b8(parent, emit) -> None:
    """B8-dq and B8-dkv of both versions at PERF.md's four shapes, in turns,
    on the same inputs, with this checkout's body and the largest difference
    of each output from the parent's."""
    import torch

    from mmada_tpu_torch.ops import flash_attention as fa
    from mmada_tpu_torch.ops import flash_attention_long as fl

    t2i, long_l = chip_smoke.T2I_FRAME, chip_smoke.LONG_FRAME
    for tag, dtype, (b, h, l), d, long in (
            ("B8 t2i CFG bf16 D256", torch.bfloat16, (4, 16, t2i), 256, False),
            ("B8 t2i CFG fp32 D128", torch.float32, (4, 32, t2i), 128, False),
            ("B8-long bf16 D256", torch.bfloat16, (1, 16, long_l), 256, True),
            ("B8-long fp32 D128", torch.float32, (1, 16, long_l), 128, True)):
        q, k, v, _, _ = chip_smoke.generic_case(dtype, b, h, h, l, l, d, False, seed=31)
        dout = torch.randn((b, h, l, d), generator=torch.Generator("cuda").manual_seed(32),
                           device="cuda").to(dtype)
        fwd, dq_fn, dkv_fn = ((fl.flash_attention_long, fl.attention_bwd_dq_long,
                               fl.attention_bwd_dkv_long) if long else
                              (fa.flash_attention, fa.attention_bwd_dq, fa.attention_bwd_dkv))
        delta = fa.attention_delta(fwd(q, k, v), dout)
        lse = dq_fn(q, k, v, dout, delta)[1]
        rec = dict(tag=tag, shape=[b, h, h, l, l], d=d, body=fa.generic_body(dtype, d))
        for part, fns, names in (
                ("dq", {"parent": lambda: parent(q, k, v, dout, delta, long_tier=long),
                        "this": lambda: dq_fn(q, k, v, dout, delta)}, ("dq", "lse")),
                ("dkv", {"parent": lambda: parent(q, k, v, dout, delta, lse=lse),
                         "this": lambda: dkv_fn(q, k, v, dout, lse, delta)}, ("dk", "dv"))):
            outs = {name: fn() for name, fn in fns.items()}
            iters, warm = (3, 1) if long else (10, 2)
            rec[part] = dict(
                ms=in_turns(fns, lambda fn: chip_smoke.cuda_ms(fn, iters, warm)),
                device_ms=in_turns(fns, lambda fn: device_ms(fn, iters)),
                gap_to_parent={n: dict(abs=float((a.float() - w.float()).abs().max()),
                                       rel=relative_gap(a, w))
                               for n, a, w in zip(names, outs["this"], outs["parent"])})
            del outs
        emit(dict(rec, ms={n: {"mean": rec["dq"]["ms"][n]["mean"] + rec["dkv"]["ms"][n]["mean"]}
                           for n in ("parent", "this")}))
        del q, k, v, dout, delta, lse
        torch.cuda.empty_cache()


def time_forward_kernels(b1: dict, b4: dict, emit) -> None:
    """B1 and B2 at the t2i CFG frame and the text batch, B4 at the long text
    frame, of both versions in turns, each output held against the plain
    version's (differing share) and against the parent's, bit for bit."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import flash_attention_reference

    for tag, (b, h, l), masked in (("B1 t2i CFG", (4, 32, chip_smoke.T2I_FRAME), False),
                                   ("B1 text batch", (3, 32, chip_smoke.TEXT_FRAME), False),
                                   ("B2 t2i CFG + mask", (4, 32, chip_smoke.T2I_FRAME), True)):
        q, k, v, sin, cos = chip_smoke.attention_case(b, h, h, l, l, True, seed=11)
        kw = dict(rope_sin=sin, rope_cos=cos,
                  bias=chip_smoke.t2i_mask_bias(cfg_batch=True) if masked else None)
        want = flash_attention_reference(q, k, v, **kw)
        outs = {name: fn(q, k, v, **kw) for name, fn in b1.items()}
        shares = {name: differing_share(out, want) for name, out in outs.items()}
        times = in_turns(b1, lambda fn: chip_smoke.cuda_ms(lambda: fn(q, k, v, **kw), 10))
        device = in_turns(b1, lambda fn: device_ms(lambda: fn(q, k, v, **kw)))
        rec = dict(tag=tag, shape=[b, h, h, l, l], ms=times, device_ms=device,
                   differing_share=shares,
                   same_as_parent=bool(torch.equal(outs["this"], outs["parent"])))
        if masked:  # the bias rows each head reads, against the kernel's time
            bias_bytes = 2 * h * kw["bias"].numel() * 4   # both passes, every head
            rec["bias_bytes_read"] = bias_bytes
            rec["bias_tb_per_s"] = {name: bias_bytes / (t["mean"] * 1e-3) / 1e12
                                    for name, t in device.items()}
        emit(rec)
        del q, k, v, want, kw, outs

    l = chip_smoke.LONG_FRAME
    q, k, v, _, _ = chip_smoke.attention_case(1, 32, 32, l, l, False, seed=12)
    outs = {name: fn(q, k, v) for name, fn in b4.items()}
    times = in_turns(b4, lambda fn: chip_smoke.cuda_ms(lambda: fn(q, k, v), 10))
    device = in_turns(b4, lambda fn: device_ms(lambda: fn(q, k, v)))
    emit(dict(tag="B4 long text", shape=[1, 32, 32, l, l], ms=times, device_ms=device,
              same_as_parent=bool(torch.equal(outs["this"], outs["parent"]))))
    del q, k, v, outs


def time_model_forwards(b1: dict, b4: dict, emit) -> None:
    """Four 8B forwards through one version's B1 / B2 and B4 or the
    other's, in turns."""
    import dataclasses

    import torch

    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import attention

    l = chip_smoke.LONG_FRAME
    cfg = llada.llada_8b()
    model = MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(0), policy=BF16)
    masked = dataclasses.replace(model, cfg=dataclasses.replace(cfg, attention_bias_enabled=True))
    t2i = chip_smoke.t2i_frames()
    t2i_mask = torch.as_tensor(chip_smoke.t2i_masks(cfg_batch=True), device="cuda")
    n = chip_smoke.T2I_SETTINGS["num_vq_tokens"]
    long_ids = torch.randint(0, 256, (1, l), generator=torch.Generator().manual_seed(3)).cuda()
    block = chip_smoke.LONG_TEXT_SETTINGS["block_length"]
    text = torch.randint(0, 256, (len(chip_smoke.TEXT_PROMPTS), chip_smoke.TEXT_FRAME),
                         generator=torch.Generator().manual_seed(4)).cuda()
    text_block = chip_smoke.TEXT_SETTINGS["block_length"]
    image = dict(logit_window=MMADA_8B.image_window, logit_positions=(t2i.shape[1] - n - 1, n))
    forwards = {
        "text forward (3 x 159)": lambda: model.forward(
            text, logit_positions=(text.shape[1] - text_block, text_block)),
        "t2i forward (4 x 1,155)": lambda: model.forward(t2i, **image),
        "masked t2i forward (4 x 1,155)": lambda: masked.forward(
            t2i, attention_mask=t2i_mask, **image),
        "long text forward (1 x 8,192)": lambda: model.forward(
            long_ids, logit_positions=(l - block, block)),
    }
    kernels = {"parent": (b1["parent"], b4["parent"]), "this": (b1["this"], b4["this"])}

    def through(pair, measure):
        attention.flash_attention, attention.flash_attention_long = pair
        try:
            with torch.no_grad():
                return measure()
        finally:
            attention.flash_attention, attention.flash_attention_long = kernels["this"]

    for tag, fwd in forwards.items():
        times = in_turns(kernels, lambda pair: through(pair, lambda: chip_smoke.cuda_ms(fwd, 3, 1)))
        device = in_turns(kernels, lambda pair: through(pair, lambda: device_ms(fwd, 3)))
        emit(dict(tag=tag, ms=times, device_ms=device))


if __name__ == "__main__":
    sys.exit(main())
