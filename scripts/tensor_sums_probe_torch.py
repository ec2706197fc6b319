"""How summing a row-parallel bf16 product over tensor ranks rounds, on the card.

The layer probe of ROADMAP C.8, on one card: a bf16 product at the 8B's
attn_out and ff_out shapes split over T = 2 and 4 ranks along K, its
partials summed (a) in bf16 after each rank rounds its own, as the port did
before, or (b) in fp32 and rounded once, as the port's collectives do now;
each sum's rel L2 from the exact (fp64) product, the share of its outputs
equal to the correctly rounded product (the whole product's too), and a
shard's product time with a bf16 and with an fp32 output (CUDA events).

Usage:

    python3 scripts/tensor_sums_probe_torch.py

One JSON line a shape on stdout; all of them in `chiprun_out/tensor_sums.json`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

LAYER_SHAPES = (("attn_out t2i CFG", 4620, 4096), ("ff_out t2i CFG", 4620, 12288),
                ("ff_out train (1,2,2)", 3096, 12288))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_probe() -> list:
    import torch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator("cuda").manual_seed(0)
    out = []
    for name, m, k_full in LAYER_SHAPES:
        x = torch.randn(m, k_full, device="cuda", generator=g).to(torch.bfloat16)
        w = (torch.randn(k_full, 4096, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
        exact = x.double() @ w.double()
        rounded = exact.to(torch.bfloat16)

        def rel(y):
            return float((y.double() - exact).norm() / exact.norm())

        def share(y):
            return float((y == rounded).float().mean())

        rec = dict(name=name, m=m, k=k_full, n=4096, whole_rel=rel(x @ w),
                   whole_equal=share(x @ w), sums={})
        for t in (2, 4):
            k = k_full // t
            xs = [x[:, i * k:(i + 1) * k] for i in range(t)]
            ws = [w[i * k:(i + 1) * k] for i in range(t)]
            in_bf16 = xs[0] @ ws[0]
            for a, b in zip(xs[1:], ws[1:]):
                in_bf16 = in_bf16 + a @ b
            in_fp32 = sum(torch.mm(a, b, out_dtype=torch.float32)
                          for a, b in zip(xs, ws)).to(torch.bfloat16)
            a, b = xs[0].contiguous(), ws[0].contiguous()
            rec["sums"][t] = dict(
                bf16_rel=rel(in_bf16), bf16_equal=share(in_bf16), fp32_rel=rel(in_fp32),
                fp32_equal=share(in_fp32), shard_bf16_ms=cuda_ms(lambda: a @ b),
                shard_fp32_out_ms=cuda_ms(lambda: torch.mm(a, b, out_dtype=torch.float32)))
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del x, w, exact, rounded
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0], f"| torch {torch.__version__}", flush=True)
    summary = dict(device=smi.strip().splitlines()[0], layers=layer_probe())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tensor_sums.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
