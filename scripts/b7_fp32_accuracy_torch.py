#!/usr/bin/env python3
"""How far B7's fp32 forward and its plain version each lie from the same
function evaluated in float64, on one NVIDIA GPU.

    python3 scripts/b7_fp32_accuracy_torch.py [--out out/b7_fp32_accuracy.json]

For each fp32 case of `chip_smoke.generic_cases()` (the same inputs, from
the same seeds, as phase 14a), prints one JSON line: the largest absolute
difference of B7's output from the plain version's (the bar phase 14a holds
it to, `chip_smoke.GENERIC_FWD_ATOL`), and of each of them from the float64
evaluation of the one-pass function (`chip_smoke.float64_attention`:
scores, softmax and p . v in float64 on the rotated operands; phase 14a
holds B7 to `chip_smoke.GENERIC_F64_RATIO` times the plain version's
distance from it). The plain version normalises p before p . v; B7's
ffma body walks K once and divides last, so the two differ only by the
order of their fp32 sums, and this shows how that difference compares with
the plain version's own rounding. Then the card's name and power limit as
nvidia-smi reports them. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b7_fp32_accuracy: no CUDA device", file=sys.stderr)
        return 2

    from mmada_tpu_torch.ops import _build
    from mmada_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        generic_body,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["attention_generic"])
    records = []
    for i, (tag, dtype, b, h, kvh, lq, lk, d, rope, make_bias) in enumerate(
            chip_smoke.generic_cases()):
        if dtype != torch.float32:
            continue
        q, k, v, sin, cos = chip_smoke.generic_case(dtype, b, h, kvh, lq, lk, d, rope,
                                                    seed=1400 + i)
        bias = make_bias() if make_bias else None
        kw = dict(rope_sin=sin, rope_cos=cos, bias=bias)
        got = flash_attention(q, k, v, **kw).double()
        plain = flash_attention_reference(q, k, v, **kw).double()
        exact = chip_smoke.float64_attention(q, k, v, sin, cos, bias)
        rec = dict(tag=tag, shape=[b, h, kvh, lq, lk], d=d, body=generic_body(dtype, d),
                   kernel_vs_plain=float((got - plain).abs().max()),
                   kernel_vs_float64=float((got - exact).abs().max()),
                   plain_vs_float64=float((plain - exact).abs().max()))
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del q, k, v, got, plain, exact
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
