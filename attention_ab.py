#!/usr/bin/env python3
"""Times the serving path's attention forwards, B1 and B4, against those of
another checkout of the port, in turns on one NVIDIA GPU.

    python3 attention_ab.py PARENT_DIR [--out chiprun_out/attention_ab.json]

PARENT_DIR is an unpacked checkout of the commit to compare with (for
example `git archive HEAD | tar -x -C chip_checkout`). Its kernels are built
from its own `mmada_tpu_torch/ops/csrc` with its own `_build.py` and launched
through their C entries with the signatures they had there (q, k, v and the
output by element strides): B1 `mmada_flash_attention_fwd_bf16` and B4
`mmada_flash_attention_long_fwd_bf16`. This checkout's kernels run through
its wrappers. Each measurement runs in the order parent, this, this, parent,
on the same inputs:

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
    kernels a forward launches (3 forwards).

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
    """(B1, B4) of the checkout at `parent_dir`, as callables with the
    signatures of this checkout's `flash_attention` and
    `flash_attention_long` (no bias)."""
    import torch

    path = os.path.join(parent_dir, "mmada_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build_all(["flash_attention_fwd", "flash_attention_long"])
    p, i = ctypes.c_void_p, ctypes.c_int
    b1 = build.load_library("flash_attention_fwd").mmada_flash_attention_fwd_bf16
    b1.argtypes = [p] * 8 + [i] * 6 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
    b4 = build.load_library("flash_attention_long").mmada_flash_attention_long_fwd_bf16
    b4.argtypes = [p] * 4 + [i] * 6 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
    b1.restype = b4.restype = ctypes.c_int

    def strides(*ts):
        flat = [s for t in ts for s in t.stride()[:3]]
        return (ctypes.c_longlong * len(flat))(*flat)

    def setup(q, k):
        b, h, lq, d = q.shape
        out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
        return out, (b, h, k.shape[1], lq, k.shape[2], d), 1.0 / d ** 0.5

    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def flash_attention(q, k, v, rope_sin=None, rope_cos=None, bias=None):
        assert bias is None
        out, dims, scale = setup(q, k)
        q_rot = k_rot = None
        if rope_sin is not None:
            q_rot, k_rot = torch.empty_like(q, memory_format=torch.contiguous_format), \
                torch.empty_like(k, memory_format=torch.contiguous_format)
        ptrs = [t.data_ptr() if t is not None else None
                for t in (q, k, v, out, rope_sin, rope_cos, q_rot, k_rot)]
        err = b1(*ptrs, *dims, strides(q, k, v, out), scale, stream(q))
        if err:
            raise RuntimeError(f"parent B1 failed: cudaError {err}")
        return out

    def flash_attention_long(q, k, v, bias=None):
        assert bias is None
        out, dims, scale = setup(q, k)
        err = b4(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
                 strides(q, k, v, out), scale, stream(q))
        if err:
            raise RuntimeError(f"parent B4 failed: cudaError {err}")
        return out

    return flash_attention, flash_attention_long


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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent_dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2

    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import _build, attention
    from mmada_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from mmada_tpu_torch.ops.flash_attention_long import flash_attention_long

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(["flash_attention_fwd", "flash_attention_long"])
    parent_b1, parent_b4 = parent_kernels(args.parent_dir)
    b1 = {"parent": parent_b1, "this": flash_attention}
    b4 = {"parent": parent_b4, "this": flash_attention_long}
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

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
    kernels = {"parent": (parent_b1, parent_b4), "this": (flash_attention, flash_attention_long)}

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

    print(smi, flush=True)
    summary = {r["tag"]: {name: t["mean"] for name, t in r["ms"].items()} for r in records}
    print(json.dumps({"card": smi, "mean_ms": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records, "mean_ms": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
