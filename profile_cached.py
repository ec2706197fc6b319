#!/usr/bin/env python3
"""Where the time of the port's block-KV cached decode goes, on one NVIDIA GPU.

    python3 profile_cached.py [--out chiprun_out/profile_cached.json]

Builds the port's kernels and the full-width 8B (`llada_8b()`, bf16, random
weights from seed 0, on the card). For each frame of `chip_smoke.py`'s
cached phase, text (3 x 159 tokens, a 32-token block), MMU (1 x 1,194, a
128-token block) and t2i (4 x 1,155, the CFG batch, its 1,024 image positions
as the span of a compact cache, the head over the image window), it runs one
exact forward (the head over the block), one capture of the bf16 cache and
one cached step on the bf16 and on the int8 cache. For each it reports:

  * `wall_ms`: host clock, synchronised, the mean of 5 calls after a
    warm-up, without the profiler;
  * from one more call under torch.profiler, `profiled_wall_ms` (that
    call's host clock, synchronised), `busy_ms` (the summed device time of
    the kernels it launched), `busy_share` = busy_ms / profiled_wall_ms (one
    stream: a share above 1 is a measurement fault and stops the run), the
    kernels launched, the aten ops issued (nested ones too) and the five
    costliest kernels.

The profiler's own host work lengthens `profiled_wall_ms`, so `busy_share`
understates the busy share of an unprofiled call. MMU's image codes are
random ids of the image vocabulary from seed 0 (the cost of a forward does
not depend on the ids). Prints one JSON line per measurement, the card's
name and power limit as nvidia-smi reports them, and a summary JSON line
last; with --out, writes all of it there too. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import chip_smoke


def measure(fn, repeats: int = 5) -> dict:
    """Wall ms of `fn` (mean of `repeats`, after a warm-up), then one call
    under torch.profiler: its wall and busy ms, kernels, aten ops and the
    costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / repeats * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_ms=wall, profiled_wall_ms=profiled_wall, busy_ms=busy,
                busy_share=busy / profiled_wall, kernels=sum(e.count for e in kernels),
                aten_ops=sum(e.count for e in events if e.key.startswith("aten::")
                             and e.device_type == torch.autograd.DeviceType.CPU),
                top=[dict(kernel=e.key[:80], ms=e.self_device_time_total / 1e3, count=e.count)
                     for e in top])


def paths(model, frame, block_start, block, window=None) -> dict:
    """The exact forward, the capture and the bf16 and int8 cached steps of
    `frame` over [block_start, block_start + block); with `window` (t2i) the
    span is left out of the cache (compact) and the head covers that vocab
    window."""
    from mmada_tpu_torch.models import llada

    cfg, params, policy = model.cfg, model.params, model.policy
    blk = frame[:, block_start:block_start + block]
    drop = None if window is None else (block_start, block_start + block)

    def capture(cache_dtype=None):
        return llada.forward_kv_capture(params, cfg, frame, policy=policy, drop_span=drop,
                                        cache_dtype=cache_dtype)

    def step(kv):
        return llada.forward_kv_step(params, cfg, blk, kv, block_start, policy=policy,
                                     logit_window=window, cache_is_compact=window is not None)

    kv, kv8 = capture(), capture("int8")
    return {
        "exact forward": lambda: model.forward(frame, logit_window=window,
                                               logit_positions=(block_start, block)),
        "capture": capture,
        "cached step": lambda: step(kv),
        "cached step int8": lambda: step(kv8),
    }


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cached: no CUDA device", file=sys.stderr)
        return 2

    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import text_frames
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    model = MMadaModel.init(llada.llada_8b(), MMADA_8B, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(0), policy=BF16)

    prompts = torch.tensor(text_frames(model, chip_smoke.TEXT_PROMPTS), device="cuda")
    gen, block = chip_smoke.TEXT_SETTINGS["gen_length"], chip_smoke.TEXT_SETTINGS["block_length"]
    text = torch.cat([prompts, torch.full((prompts.shape[0], gen), MMADA_8B.mask_token_id,
                                          device="cuda")], dim=1)
    codes = torch.randint(0, MMADA_8B.image_codebook_size, (1024,), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    mmu_new = chip_smoke.MMU_SETTINGS["max_new_tokens"]
    n_img = chip_smoke.T2I_SETTINGS["num_vq_tokens"]
    frames = {
        "text": (text, prompts.shape[1], block, None),
        "mmu": (chip_smoke.mmu_frame(model, codes), chip_smoke.MMU_FRAME - mmu_new,
                chip_smoke.MMU_SETTINGS["block_length"], None),
        "t2i": (chip_smoke.t2i_frames(), chip_smoke.T2I_FRAME - n_img - 1, n_img,
                MMADA_8B.image_window),
    }
    records = []
    for tag, (frame, start, length, window) in frames.items():
        for name, fn in paths(model, frame, start, length, window).items():
            rec = dict(frame=tag, path=name, shape=list(frame.shape), block=length,
                       **measure(fn))
            records.append(rec)
            print(json.dumps(rec), flush=True)
            if rec["busy_share"] > 1:
                raise AssertionError(f"{tag} {name}: the kernels' device time exceeds the "
                                     f"call's wall time: {rec}")
    summary = {"device": smi, "records": [
        {k: r[k] for k in ("frame", "path", "wall_ms", "profiled_wall_ms", "busy_ms",
                           "busy_share", "kernels")} for r in records]}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(summary, full=records), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
