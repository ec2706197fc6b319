"""How summing a row-parallel bf16 product over tensor ranks rounds, on the card.

The layer probe of ROADMAP C.8, on one card: a bf16 product at the 8B's
attn_out and ff_out shapes split over T = 2 and 4 ranks along K, its
partials summed (a) in bf16 after each rank rounds its own, as the port did
before, or (b) in fp32 and rounded once, as the port's collectives do now;
each sum's rel L2 from the exact (fp64) product, the share of its outputs
equal to the correctly rounded product (the whole product's too), and a
shard's product time with a bf16 and with an fp32 output (CUDA events).

The four-card witness (`--witness`): one spawned rank a card builds the 8B
from seed 0 in bf16; rank 0 takes the whole model's first t2i forward (the
CFG batch of two prompts, the image window over the image span) and the same
forward of the same weights in fp32; then the weights are sharded over
tensor = every rank and the forward runs with the row-parallel sums in fp32
rounded once (the port's) and, for comparison, rounded and summed in bf16
(the rule before ROADMAP C.8's repair); each one's rel L2 from the fp32 and
the whole bf16 logits, and its time (CUDA events, the mean of several
forwards after a warm one). Each rank writes its traceback to its own file
(`chiprun_out/witness/rank<r>.txt`), which the parent prints before it
exits with an error; the rendezvous store waits at most
WITNESS_STORE_TIMEOUT_S. `--cpu --tiny` rehearses it over gloo at tiny
widths.

Usage:

    python3 scripts/tensor_sums_probe_torch.py
    python3 scripts/tensor_sums_probe_torch.py --witness [--ranks 4]
    python3 scripts/tensor_sums_probe_torch.py --witness --cpu --tiny --ranks 2

One JSON line a shape on stdout; all of them in `chiprun_out/tensor_sums.json`
(the witness: `chiprun_out/witness.json`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

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


WITNESS_STORE_TIMEOUT_S = 60
WITNESS_DEADLINE_S = 900
WITNESS_ITERS = 5
T2I_PROMPT_LEN, T2I_CODES = 128, 1024       # the smoke's T2I_FRAME: 128 + 1 + 1024 + 2


def _bf16_row_sums(x, w, tp):
    """The row-parallel product as the port summed it before C.8's repair:
    each rank's partial rounded to x's dtype, the sum in x's dtype."""
    import torch.distributed as dist

    from mmada_tpu_torch.ops.quantization import maybe_matmul

    out = maybe_matmul(x, w).contiguous()
    dist.all_reduce(out, group=tp)
    return out


def fp32_logits(model, ids, kw):
    """`model.forward(ids, **kw)` in fp32: each layer's weights cast to fp32
    in turn, attention by the kernels' plain version (the kernels take bf16
    only), TF32 off. `chip_smoke.py`'s phase 12 takes its witness with it
    too."""
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.ops import attention
    from mmada_tpu_torch.ops.flash_attention import flash_attention_reference

    cfg, params = model.cfg, model.params
    start, n = kw["logit_positions"]
    lo, hi = kw["logit_window"]
    x = params["wte"][ids].float()
    sin, cos = llada.rope_sin_cos(ids.shape[1], cfg.head_dim, cfg.rope_theta, device=ids.device)
    inner = attention.flash_attention
    attention.flash_attention = flash_attention_reference
    try:
        for lp in llada.layer_params(params):
            x = llada._block(cfg, x, {k: v.float() for k, v in lp.items()}, None, sin, cos)
    finally:
        attention.flash_attention = inner
    x = llada._norm(cfg, x[:, start:start + n], params["ln_f"].float())
    head = params["wte"].T if cfg.weight_tying else params["ff_out"]
    return x @ head[:, lo:hi].float()


def _witness_rank(rank: int, world: int, tmp: str, out_dir: str, cpu: bool, tiny: bool) -> None:
    try:
        _witness(rank, world, tmp, cpu, tiny)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _witness(rank: int, world: int, tmp: str, cpu: bool, tiny: bool) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    from mmada_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B, tiny_layout
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.parallel import sharding

    device = "cpu" if cpu else "cuda"
    if cpu:
        torch.set_num_threads(1)
    initialize_distributed(f"file://{tmp}/rendezvous", world, rank, device=device,
                           timeout_s=WITNESS_STORE_TIMEOUT_S)
    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    vocab = tiny_layout() if tiny else MMADA_8B
    cfg = (llada.tiny_config(vocab_size=vocab.total_vocab_size, n_heads=max(4, world))
           if tiny else llada.llada_8b())
    prompt_len, codes = (8, 16) if tiny else (T2I_PROMPT_LEN, T2I_CODES)
    g = torch.Generator(device).manual_seed(1)
    ids = torch.randint(3, vocab.text_vocab_size - 32, (4, prompt_len + codes + 3), device=device,
                        generator=g)
    ids[:, prompt_len + 1:prompt_len + 1 + codes] = vocab.mask_token_id
    kw = dict(logit_window=vocab.image_window, logit_positions=(ids.shape[1] - codes - 1, codes))
    model = MMadaModel.init(cfg, vocab, device=device, dtype=torch.bfloat16,
                            generator=torch.Generator(device).manual_seed(0), policy=BF16)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def timed(fn) -> float:
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(WITNESS_ITERS):
            fn()
        sync()
        return (time.perf_counter() - t) / WITNESS_ITERS * 1e3

    out = {}
    if rank == 0:
        whole = model.forward(ids, **kw).float()
        out["whole_ms"] = timed(lambda: model.forward(ids, **kw))
        exact = fp32_logits(model, ids, kw)
    dist.barrier()
    mesh = make_mesh(data=1, fsdp=1, tensor=world, device=device)
    specs = sharding.model_specs(cfg, mesh, model.params)
    sharded = dataclasses.replace(model, mesh=mesh,
                                  params=sharding.shard_params(model.params, specs, mesh))
    del model
    if not cpu:
        torch.cuda.empty_cache()
    fp32_sums = llada._row_parallel
    for name, rule in (("fp32 sums", fp32_sums), ("bf16 sums", _bf16_row_sums),
                       ("fp32 sums again", fp32_sums)):
        llada._row_parallel = rule
        try:
            logits = sharded.forward(ids, **kw).float()
            ms = timed(lambda: sharded.forward(ids, **kw))
        finally:
            llada._row_parallel = fp32_sums
        if rank == 0:
            def rel(a, b):
                return float((a - b).norm() / b.norm())

            out[name] = dict(ms=ms, rel_fp32=rel(logits, exact), rel_whole=rel(logits, whole))
    if rank == 0:
        out.update(world=world, shape=list(ids.shape), whole_rel_fp32=float(
            (whole - exact).norm() / exact.norm()))
        with open(os.path.join(tmp, "witness.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def witness(world: int, cpu: bool, tiny: bool) -> dict:
    """The four-card witness (the module docstring), one spawned rank a card."""
    import multiprocessing as mp

    out_dir = os.path.join("chiprun_out", "witness")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    tmp = tempfile.mkdtemp(prefix="witness_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_witness_rank, args=(r, world, tmp, out_dir, cpu, tiny))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WITNESS_DEADLINE_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(2)    # the others' errors reach their files
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    if any(codes):
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                print(f"--- {name}\n{f.read()}", file=sys.stderr, flush=True)
        raise SystemExit(f"witness ranks ended with {codes}")
    with open(os.path.join(tmp, "witness.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU over gloo")
    ap.add_argument("--tiny", action="store_true", help="tiny widths (a rehearsal)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = "cpu"
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        device = smi.strip().splitlines()[0]
    print(device, f"| torch {torch.__version__}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    if args.witness:
        world = args.ranks or (2 if args.cpu else torch.cuda.device_count())
        summary = dict(device=device, **witness(world, args.cpu, args.tiny))
        print(json.dumps(summary), flush=True)
        with open(os.path.join("chiprun_out", "witness.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    summary = dict(device=device, layers=layer_probe())
    with open(os.path.join("chiprun_out", "tensor_sums.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
