#!/usr/bin/env python3
"""Times the attention kernels B1, B4 (the serving path's forwards) and B5
(the long training path's staged backward) against those of another
checkout of the port, in turns on one NVIDIA GPU.

    python3 attention_ab.py PARENT_DIR [--out chiprun_out/attention_ab.json]
                            [--only forward|backward]

PARENT_DIR is an unpacked checkout of the commit to compare with (for
example `git archive HEAD | tar -x -C chip_checkout`). Its kernels are built
from its own `mmada_tpu_torch/ops/csrc` with its own `_build.py` and launched
through their C entries with the signatures they had there: B1
`mmada_flash_attention_fwd_bf16` and B4 `mmada_flash_attention_long_fwd_bf16`
by tensor maps (as here, so through this checkout's wrappers), B5-dq
`mmada_flash_attention_long_bwd_dq_bf16` and B5-dkv
`mmada_flash_attention_long_bwd_dkv_bf16` by element strides (before their
redesign on wgmma). This checkout's kernels run through its wrappers. Each measurement runs in the order parent, this, this,
parent, on the same inputs:

  * B1 at the t2i CFG batch (4 x 32 heads x 1,155 tokens, RoPE) and at the
    served text batch (3 x 32 x 159, RoPE), B4 at the long text frame (1 x 32
    x 8,192): CUDA events, 10 calls after 2 warm-up, and the device time of
    the kernels a call launches (torch.profiler, 10 calls: it leaves out
    the time the stream waits for the host); beside B1's, the share of its
    output elements that differ from the plain version's
    (`flash_attention_reference`);
  * one forward of the full-width 8B (random weights from seed 0, bf16) at
    the served text batch (3 x 159 tokens, the head over one 32-token block),
    at the t2i CFG batch (the sampler's first forward, windowed head) and on
    the 8,192-token text frame (the head over one 64-token block), with the
    model's attention calls sent to one version's kernels or the other's:
    CUDA events, 3 calls after 1 warm-up, and the device time of the
    kernels a forward launches (3 forwards);
  * B5-dq and B5-dkv (no bias) at the long training batch (2 x 32 heads x
    8,192 tokens) and at 16,384 tokens (1 x 2 heads): CUDA events, 10 calls
    after 2 warm-up, and the device time of a call; beside them the largest
    difference of each output from the parent's, relative to the parent's
    largest entry (lse: absolute).

`--only forward` runs the first two, `--only backward` the last.

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


def parent_kernels(parent_dir: str):
    """(B1, B4, B5-dq, B5-dkv) of the checkout at `parent_dir`, as callables
    with the signatures of this checkout's `flash_attention`,
    `flash_attention_long`, `attention_bwd_dq_long` and
    `attention_bwd_dkv_long` (no bias). B1's and B4's C entries take the
    operands' tensor maps, as this checkout's do, so the parent's run
    through this checkout's wrappers (`_through`); B5's take element
    strides."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import flash_attention
    from mmada_tpu_torch.ops.flash_attention_long import flash_attention_long

    path = os.path.join(parent_dir, "mmada_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build_all(["flash_attention_fwd", "flash_attention_long"])
    p, i = ctypes.c_void_p, ctypes.c_int

    def entry(source, name, n_ptr, lists):
        fn = getattr(build.load_library(source), name)
        fn.argtypes = [p] * n_ptr + [i] * 6 + lists + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        return fn

    b1_name, b4_name = "mmada_flash_attention_fwd_bf16", "mmada_flash_attention_long_fwd_bf16"
    b1 = entry("flash_attention_fwd", b1_name, 8, [p, p])
    b4 = entry("flash_attention_long", b4_name, 4, [p])
    by_strides = [ctypes.POINTER(ctypes.c_longlong)]
    dq_fn = entry("flash_attention_long", "mmada_flash_attention_long_bwd_dq_bf16", 7, by_strides)
    dkv_fn = entry("flash_attention_long", "mmada_flash_attention_long_bwd_dkv_bf16", 8,
                   by_strides)

    def strides(*ts):
        flat = [s for t in ts for s in t.stride()[:3]]
        return (ctypes.c_longlong * len(flat))(*flat)

    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def attention_bwd_dq_long(q, k, v, dout, delta):
        b, h, lq, d = q.shape
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        err = dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), lse.data_ptr(), b, h, k.shape[1], lq, k.shape[2], d,
                    strides(q, k, v, dout, dq), 1.0 / d ** 0.5, stream(q))
        if err:
            raise RuntimeError(f"parent B5-dq failed: cudaError {err}")
        return dq, lse

    def attention_bwd_dkv_long(q, k, v, dout, lse, delta):
        b, h, lq, d = q.shape
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        err = dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], lq,
                     k.shape[2], d, strides(q, k, v, dout, dk, dv), 1.0 / d ** 0.5, stream(q))
        if err:
            raise RuntimeError(f"parent B5-dkv failed: cudaError {err}")
        return dk, dv

    return (_through(flash_attention, b1_name, b1), _through(flash_attention_long, b4_name, b4),
            attention_bwd_dq_long, attention_bwd_dkv_long)


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
    """measure(fn) in the order parent, this, this, parent; every value and
    the mean per version."""
    order = ["parent", "this", "this", "parent"]
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


def time_b5(b5: dict, emit) -> None:
    """B5-dq and B5-dkv of both versions at the long training batch and at
    16,384 tokens, in turns, on the same inputs."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import attention_delta
    from mmada_tpu_torch.ops.flash_attention_long import flash_attention_long

    for tag, (b, h, l) in (("long train", (chip_smoke.LONG_TRAIN_ROWS, 32, chip_smoke.LONG_FRAME)),
                           ("L16384, 2 heads", (1, 2, 16384))):
        q, k, v, _, _ = chip_smoke.attention_case(b, h, h, l, l, False, seed=13)
        g = torch.Generator("cuda").manual_seed(14)
        dout = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
        delta = attention_delta(flash_attention_long(q, k, v), dout)
        outs = {name: fns[0](q, k, v, dout, delta) for name, fns in b5.items()}
        lse = outs["parent"][1]
        grads = {name: fns[1](q, k, v, dout, lse, delta) for name, fns in b5.items()}
        gap = {"dq": relative_gap(outs["this"][0], outs["parent"][0]),
               "lse_abs": float((outs["this"][1] - lse).abs().max()),
               "dk": relative_gap(grads["this"][0], grads["parent"][0]),
               "dv": relative_gap(grads["this"][1], grads["parent"][1])}
        for kernel, call in (("B5-dq", lambda fns: fns[0](q, k, v, dout, delta)),
                             ("B5-dkv", lambda fns: fns[1](q, k, v, dout, lse, delta))):
            times = in_turns(b5, lambda fns: chip_smoke.cuda_ms(lambda: call(fns), 10))
            device = in_turns(b5, lambda fns: device_ms(lambda: call(fns)))
            emit(dict(tag=f"{kernel} {tag}", shape=[b, h, h, l, l], ms=times, device_ms=device,
                      gap_to_parent=gap))
        del q, k, v, dout, delta, outs, grads, lse
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=("forward", "backward"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2

    from mmada_tpu_torch.ops import _build
    from mmada_tpu_torch.ops.flash_attention import flash_attention
    from mmada_tpu_torch.ops.flash_attention_long import (
        attention_bwd_dkv_long,
        attention_bwd_dq_long,
        flash_attention_long,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(["flash_attention_fwd", "flash_attention_long"])
    parent_b1, parent_b4, parent_dq, parent_dkv = parent_kernels(args.parent_dir)
    b1 = {"parent": parent_b1, "this": flash_attention}
    b4 = {"parent": parent_b4, "this": flash_attention_long}
    b5 = {"parent": (parent_dq, parent_dkv), "this": (attention_bwd_dq_long,
                                                     attention_bwd_dkv_long)}
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if args.only != "forward":
        time_b5(b5, emit)
    if args.only != "backward":
        time_forwards(b1, b4, emit)
    print(smi, flush=True)
    summary = {r["tag"]: {name: t["mean"] for name, t in r["ms"].items()} for r in records}
    print(json.dumps({"card": smi, "mean_ms": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "mean_ms": summary}, f, indent=1)
    return 0


def time_forwards(b1: dict, b4: dict, emit) -> None:
    """B1 and B4 of both versions, and three 8B forwards through one
    version's forwards or the other's, in turns."""
    import torch

    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import attention
    from mmada_tpu_torch.ops.flash_attention import flash_attention_reference

    for tag, (b, h, l) in (("B1 t2i CFG", (4, 32, chip_smoke.T2I_FRAME)),
                           ("B1 text batch", (3, 32, chip_smoke.TEXT_FRAME))):
        q, k, v, sin, cos = chip_smoke.attention_case(b, h, h, l, l, True, seed=11)
        want = flash_attention_reference(q, k, v, rope_sin=sin, rope_cos=cos)
        shares = {name: differing_share(fn(q, k, v, rope_sin=sin, rope_cos=cos), want)
                  for name, fn in b1.items()}
        times = in_turns(b1, lambda fn: chip_smoke.cuda_ms(
            lambda: fn(q, k, v, rope_sin=sin, rope_cos=cos), 10))
        device = in_turns(b1, lambda fn: device_ms(lambda: fn(q, k, v, rope_sin=sin,
                                                               rope_cos=cos)))
        emit(dict(tag=tag, shape=[b, h, h, l, l], ms=times, device_ms=device,
                  differing_share=shares))
        del q, k, v, want

    l = chip_smoke.LONG_FRAME
    q, k, v, _, _ = chip_smoke.attention_case(1, 32, 32, l, l, False, seed=12)
    times = in_turns(b4, lambda fn: chip_smoke.cuda_ms(lambda: fn(q, k, v), 10))
    device = in_turns(b4, lambda fn: device_ms(lambda: fn(q, k, v)))
    emit(dict(tag="B4 long text", shape=[1, 32, 32, l, l], ms=times, device_ms=device))
    del q, k, v

    cfg = llada.llada_8b()
    model = MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(0), policy=BF16)
    t2i = chip_smoke.t2i_frames()
    n = chip_smoke.T2I_SETTINGS["num_vq_tokens"]
    long_ids = torch.randint(0, 256, (1, l), generator=torch.Generator().manual_seed(3)).cuda()
    block = chip_smoke.LONG_TEXT_SETTINGS["block_length"]
    text = torch.randint(0, 256, (len(chip_smoke.TEXT_PROMPTS), chip_smoke.TEXT_FRAME),
                         generator=torch.Generator().manual_seed(4)).cuda()
    text_block = chip_smoke.TEXT_SETTINGS["block_length"]
    forwards = {
        "text forward (3 x 159)": lambda: model.forward(
            text, logit_positions=(text.shape[1] - text_block, text_block)),
        "t2i forward (4 x 1,155)": lambda: model.forward(
            t2i, logit_window=MMADA_8B.image_window,
            logit_positions=(t2i.shape[1] - n - 1, n)),
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
