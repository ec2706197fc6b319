#!/usr/bin/env python3
"""Times the attention kernels B1, B2, B4 and B4-bias (the forwards), B3 and
B3-bias (the one-pass backward), B5 (the long training path's staged
backward, unbiased and biased) and the int4 matmul B6 against those of
another checkout of the port, in turns on one NVIDIA GPU.

    python3 attention_ab.py PARENT_DIR [--out chiprun_out/attention_ab.json]
                            [--only forward|backward|int4]

PARENT_DIR is an unpacked checkout of the commit to compare with (for
example `git archive HEAD | tar -x -C chip_checkout`). Its kernels are built
from its own `mmada_tpu_torch/ops/csrc` with its own `_build.py` and launched
through their C entries with the signatures they had there. The parent's
B1, B2, B3, B4, B4-bias and B5 (biased and not) must take tensor maps, as
here, and run through this checkout's wrappers; so do its B3-bias and B6
unless they are the earlier `mma.sync` bodies (its csrc still holds
`flash_attention_dkv.cuh`), which are called directly, B3-bias with element
strides and B6 with row strides.
This checkout's kernels run through its wrappers. Each measurement runs in
the order parent, this, this, parent, on the same inputs:

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
    of a call; beside them the bound (`chip_smoke.int4_bound`) and the
    largest difference of the output from the parent's, in bf16 ulps of
    the larger entry.

`--only forward` runs the first two, `--only backward` the third, `--only
int4` the last.

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
    """The kernels of the checkout at `parent_dir` (B1-B5 taking tensor
    maps), as callables with the signatures of this checkout's wrappers: "forward"
    (`flash_attention`: B1, or B2 with a bias), "long" (B4, or B4-bias with a
    bias), "dq" and "dkv" (B3's, or B3-bias's with a bias), "long_dq" and
    "long_dkv" (B5's, with an optional bias), "int4" (B6). Entries that take
    the operands' tensor maps, as this checkout's do, run through this
    checkout's wrappers (`_through`); a parent's B3-bias and B6 from before
    their wgmma bodies (`strides_b3_bias_and_b6`) take strides and are
    called directly."""
    import torch

    from mmada_tpu_torch.ops import flash_attention as fa
    from mmada_tpu_torch.ops import flash_attention_long as long_mod
    from mmada_tpu_torch.ops import int4_matmul as int4_mod

    path = os.path.join(parent_dir, "mmada_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build_all(["flash_attention_fwd", "flash_attention_bwd", "flash_attention_long",
                     "int4_matmul"])
    p, i = ctypes.c_void_p, ctypes.c_int
    by_strides = [ctypes.POINTER(ctypes.c_longlong)]
    legacy = strides_b3_bias_and_b6(parent_dir)

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
    b3_dq = {"": through(fa.attention_bwd_dq, "flash_attention_bwd",
                         "mmada_flash_attention_bwd_dq_bf16", 7)}
    b3_dkv = {"": through(fa.attention_bwd_dkv, "flash_attention_bwd",
                          "mmada_flash_attention_bwd_dkv_bf16", 8)}
    if legacy:
        b3_dq["_bias"] = entry("flash_attention_bwd", "mmada_flash_attention_bwd_dq_bias_bf16",
                               8, by_strides)
        b3_dkv["_bias"] = entry("flash_attention_bwd",
                                "mmada_flash_attention_bwd_dkv_bias_bf16", 9, by_strides)
    else:
        b3_dq["_bias"] = through(fa.attention_bwd_dq, "flash_attention_bwd",
                                 "mmada_flash_attention_bwd_dq_bias_bf16", 8)
        b3_dkv["_bias"] = through(fa.attention_bwd_dkv, "flash_attention_bwd",
                                  "mmada_flash_attention_bwd_dkv_bias_bf16", 9)

    def strides(*ts, bias):
        """The element strides (batch, head, row) of each operand, then the
        bias's (0 on a broadcast axis): the strides entries' layout."""
        flat = [s for t in ts for s in t.stride()[:3]]
        flat += [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(3)]
        return (ctypes.c_longlong * len(flat))(*flat)

    def run(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {fn.__name__} failed: cudaError {err}")

    def forward(q, k, v, rope_sin=None, rope_cos=None, bias=None):
        call = b1 if bias is None else b2
        return call(q, k, v, rope_sin=rope_sin, rope_cos=rope_cos, bias=bias)

    def long_forward(q, k, v, bias=None):
        return b4(q, k, v) if bias is None else b4_bias(q, k, v, bias)

    def dq(q, k, v, dout, delta, bias=None):
        if bias is None or not legacy:
            return b3_dq["" if bias is None else "_bias"](q, k, v, dout, delta, bias)
        b, h, lq, d = q.shape
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        run(b3_dq["_bias"], q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            delta.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, k.shape[1],
            lq, k.shape[2], d, strides(q, k, v, dout, out, bias=bias), 1.0 / d ** 0.5)
        return out, lse

    def dkv(q, k, v, dout, lse, delta, bias=None):
        if bias is None or not legacy:
            return b3_dkv["" if bias is None else "_bias"](q, k, v, dout, lse, delta, bias)
        b, h, lq, d = q.shape
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        run(b3_dkv["_bias"], q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bias.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
            k.shape[1], lq, k.shape[2], d, strides(q, k, v, dout, dk, dv, bias=bias),
            1.0 / d ** 0.5)
        return dk, dv

    b6 = getattr(build.load_library("int4_matmul"), "mmada_int4_matmul_bf16")
    if legacy:
        b6.argtypes = [p] * 4 + [i] * 3 + [ctypes.c_longlong] * 3 + [p]
    else:
        b6.argtypes = [p] * 4 + [i] * 3 + [p, p]
    b6.restype = ctypes.c_int

    def int4(x, packed, scales):
        if not legacy:
            own = int4_mod._fn
            int4_mod._fn = b6
            try:
                return int4_mod.int4_matmul(x, packed, scales)
            finally:
                int4_mod._fn = own
        (m, k), n = x.shape, packed.shape[1]
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        err = b6(x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n,
                 x.stride(0), packed.stride(0), scales.stride(0),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent mmada_int4_matmul_bf16 failed: cudaError {err}")
        return out

    def b5_dq(q, k, v, dout, delta, bias=None):
        return long_dq["" if bias is None else "_bias"](q, k, v, dout, delta, bias)

    def b5_dkv(q, k, v, dout, lse, delta, bias=None):
        return long_dkv["" if bias is None else "_bias"](q, k, v, dout, lse, delta, bias)

    return {"forward": forward, "long": long_forward, "dq": dq, "dkv": dkv,
            "long_dq": b5_dq, "long_dkv": b5_dkv, "int4": int4}


def strides_b3_bias_and_b6(parent_dir: str) -> bool:
    """Whether the parent's B3-bias and B6 entries take strides (their
    mma.sync bodies: its csrc still holds flash_attention_dkv.cuh) rather
    than tensor maps."""
    return os.path.exists(os.path.join(parent_dir, "mmada_tpu_torch", "ops", "csrc",
                                       "flash_attention_dkv.cuh"))


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
                  bound_ms=bound_ms, bound_by=bound_by, ulps_from_parent=ulps))
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
    ap.add_argument("--only", choices=("forward", "backward", "int4"), default=None)
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
        time_forwards(b1, b4, emit)
    if args.only in (None, "int4"):
        time_b6({"parent": parent["int4"], "this": int4_matmul}, emit)
    print(smi, flush=True)
    summary = {r["tag"]: {name: t["mean"] for name, t in r["ms"].items()} for r in records}
    print(json.dumps({"card": smi, "mean_ms": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "mean_ms": summary}, f, indent=1)
    return 0


def time_forwards(b1: dict, b4: dict, emit) -> None:
    """B1, B2 and B4 of both versions, and four 8B forwards through one
    version's forwards or the other's, in turns."""
    import dataclasses

    import torch

    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import attention
    from mmada_tpu_torch.ops.flash_attention import flash_attention_reference

    for tag, (b, h, l), masked in (("B1 t2i CFG", (4, 32, chip_smoke.T2I_FRAME), False),
                                   ("B1 text batch", (3, 32, chip_smoke.TEXT_FRAME), False),
                                   ("B2 t2i CFG + mask", (4, 32, chip_smoke.T2I_FRAME), True)):
        q, k, v, sin, cos = chip_smoke.attention_case(b, h, h, l, l, True, seed=11)
        kw = dict(rope_sin=sin, rope_cos=cos,
                  bias=chip_smoke.t2i_mask_bias(cfg_batch=True) if masked else None)
        want = flash_attention_reference(q, k, v, **kw)
        shares = {name: differing_share(fn(q, k, v, **kw), want) for name, fn in b1.items()}
        times = in_turns(b1, lambda fn: chip_smoke.cuda_ms(lambda: fn(q, k, v, **kw), 10))
        device = in_turns(b1, lambda fn: device_ms(lambda: fn(q, k, v, **kw)))
        rec = dict(tag=tag, shape=[b, h, h, l, l], ms=times, device_ms=device,
                   differing_share=shares)
        if masked:  # the bias rows each head reads, against the kernel's time
            bias_bytes = 2 * h * kw["bias"].numel() * 4   # both passes, every head
            rec["bias_bytes_read"] = bias_bytes
            rec["bias_tb_per_s"] = {name: bias_bytes / (t["mean"] * 1e-3) / 1e12
                                    for name, t in device.items()}
        emit(rec)
        del q, k, v, want, kw

    l = chip_smoke.LONG_FRAME
    q, k, v, _, _ = chip_smoke.attention_case(1, 32, 32, l, l, False, seed=12)
    times = in_turns(b4, lambda fn: chip_smoke.cuda_ms(lambda: fn(q, k, v), 10))
    device = in_turns(b4, lambda fn: device_ms(lambda: fn(q, k, v)))
    emit(dict(tag="B4 long text", shape=[1, 32, 32, l, l], ms=times, device_ms=device))
    del q, k, v

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
