"""Model-FLOP accounting.

Counterpart of `mmada_tpu/utils/flops.py:18-32` (`forward_matmul_flops_per_token`):
matmul FLOPs only, qkvo + the gated MLP per layer, the QK^T / PV attention
products, and the vocab head. Norms, RoPE, softmax and residuals are
bandwidth, not FLOPs. The serving engine's chunk guard prices a chunk with
it; the rest of JAX's module (training FLOPs, MFU) is ROADMAP A.14.
"""

from __future__ import annotations


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
