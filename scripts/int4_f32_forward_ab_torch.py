#!/usr/bin/env python3
"""One t2i CFG forward of the int4 fp32 8B (`chip_smoke.py` phase 14c's)
through this checkout's B6-f32 and through another checkout's, in turns on
one NVIDIA GPU.

    python3 scripts/int4_f32_forward_ab_torch.py PARENT_DIR [--out out/int4_f32_forward_ab.json]

PARENT_DIR is an unpacked checkout of the commit to compare with (for
example `git archive HEAD mmada_tpu_torch | tar -x -C chip_checkout/parent`)
whose B6-f32 entry `mmada_int4_matmul_f32` takes (x, x row stride, packed,
its row stride, scales, their row stride, out, M, K, N, stream): it is built
from the parent's own sources with the parent's `_build.py` and launched in
place of this checkout's entry by the same wrapper, with one launch a call
(this checkout's split of K and its workspace are dropped for it).

The model is phase 14c's: the full-width 8B (`llada.llada_8b()`, random
weights from seed 0) under the FP32 policy, quantized to int4 (every block
matmul and the head through B6-f32), run on the two t2i CFG frames
(`chip_smoke.t2i_frames`: 4 rows of 1,155 tokens, logits over the image
span). It prints the card's name and power limit as nvidia-smi reports
them, then one JSON line: the forward's milliseconds (CUDA events, 3 calls
after 1 warm-up) in the order parent, this, this, parent, their means, the
relative L2 distance of this checkout's logits from the parent's, and the
(M, K, N, splits) of the B6-f32 launches a forward makes. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def parent_entry(parent_dir: str):
    """The parent's `mmada_int4_matmul_f32`, built from its own sources."""
    path = os.path.join(parent_dir, "mmada_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build_all(["int4_matmul_f32"])
    fn = build.load_library("int4_matmul_f32").mmada_int4_matmul_f32
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, p, ll, p, ll, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent_dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int4_f32_forward_ab: no CUDA device", file=sys.stderr)
        return 2

    from mmada_tpu_torch.core.precision import FP32
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import quantize
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import _build
    from mmada_tpu_torch.ops import int4_matmul as int4_mod

    _build.build_all(["int4_matmul_f32"])
    parent = parent_entry(args.parent_dir)
    launched = set()

    def parent_call(x, sx, packed, sp, scales, ss, out, workspace, m, k, n, splits, stream):
        launched.add((m, k, n, splits))
        return parent(x, sx, packed, sp, scales, ss, out, m, k, n, stream)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MMadaModel.init(llada.llada_8b(), MMADA_8B, device="cuda", dtype=torch.float32,
                            generator=torch.Generator("cuda").manual_seed(0), policy=FP32)
    qmodel = quantize(model, "int4")
    del model
    torch.cuda.empty_cache()
    ids = chip_smoke.t2i_frames()
    n = chip_smoke.T2I_SETTINGS["num_vq_tokens"]
    start = ids.shape[1] - n - 1
    this = int4_mod._f32_entry()
    entries = {"parent": parent_call, "this": this}

    def forward(name):
        int4_mod._f32_fn = entries[name]
        try:
            with torch.no_grad():
                return qmodel.forward(ids, logit_positions=(start, n))
        finally:
            int4_mod._f32_fn = this

    outs = {name: forward(name) for name in entries}
    rel = float((outs["this"] - outs["parent"]).norm() / outs["parent"].norm())
    del outs
    ms = {name: [] for name in entries}
    for name in ("parent", "this", "this", "parent"):
        ms[name].append(chip_smoke.cuda_ms(lambda: forward(name), 3, 1))
    rec = dict(card=smi, forward_ms=ms, mean_ms={k: sum(v) / len(v) for k, v in ms.items()},
               rel_l2_this_vs_parent=rel, b6_f32_launch_shapes=sorted(launched))
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
