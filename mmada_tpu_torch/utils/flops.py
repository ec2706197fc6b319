"""Model-FLOP accounting.

Counterpart of `mmada_tpu/utils/flops.py` (:18-62): matmul FLOPs only, qkvo
+ the gated MLP per layer, the QK^T / PV attention products, and the vocab
head. Norms, RoPE, softmax and residuals are bandwidth, not FLOPs. The
serving engine's chunk guard prices a chunk with `forward_matmul_flops_per_token`;
`train_step_flops` is a training step's numerator of the model-FLOP share of
the card's peak.
"""

from __future__ import annotations

#: dense bf16 FLOP/s of one NVIDIA H100 SXM (data sheet, without sparsity):
#: the peak the kernels' bounds and the model-FLOP share are taken against
H100_BF16_PEAK = 989e12


def forward_matmul_flops_per_token(cfg, seq_len: int, head_positions: int,
                                   head_width: int) -> float:
    """Matmul FLOPs per processed token of one forward. The head may run over
    a position window (`head_positions` of `seq_len`, a semi-AR block) and a
    vocab window (`head_width`)."""
    d, f, n = cfg.d_model, cfg.mlp_hidden_size, cfg.n_layers
    per_layer = 2 * (4 * d * d + 3 * d * f)   # qkvo + gated mlp
    attn = 4 * seq_len * d                     # QK^T + PV, all heads
    head = 2 * d * head_width * (head_positions / seq_len)
    return n * (per_layer + attn) + head


def train_step_flops(cfg, batch: int, seq_len: int, remat="full") -> tuple[float, float]:
    """(useful, hardware) FLOPs of one forward + backward step over `batch`
    rows of `seq_len` tokens. useful: three forwards' matmuls (the backward
    does two products per forward product), the model-FLOP share's
    numerator. hardware adds what remat recomputes (`llada`'s modes):
    False / None nothing; True / "full" one more forward of the layers (the
    head and the loss lie outside the checkpointed layers); "dots" keeps the
    products' outputs, so only attention's QK^T / PV run again."""
    tokens = batch * seq_len
    fwd = tokens * forward_matmul_flops_per_token(cfg, seq_len, seq_len, cfg.vocab_size)
    layers_only = tokens * forward_matmul_flops_per_token(cfg, seq_len, 0, 0)
    attn_only = tokens * cfg.n_layers * 4 * seq_len * cfg.d_model
    useful = 3.0 * fwd
    recompute = {False: 0.0, None: 0.0, True: layers_only, "full": layers_only,
                 "dots": attn_only}[remat]
    return useful, useful + recompute
