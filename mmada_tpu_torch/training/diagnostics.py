"""Per-masked-ratio-bucket training diagnostics.

Counterpart of `mmada_tpu/training/diagnostics.py` (:18-51), the reference's
metrics helpers (models/training_utils.py:299-455): batch rows bucketed by
their masking ratio, with each bucket's cross-entropy, prediction entropy
and token count, the instrument for finding which diffusion noise levels a
masked-diffusion model handles poorly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmada_tpu_torch.training.losses import masked_cross_entropy


def mask_ratio_bucket_stats(
    logits: torch.Tensor,          # (B, L, V)
    labels: torch.Tensor,          # (B, L) with IGNORE_ID
    masked_indices: torch.Tensor,  # (B, L) bool
    num_buckets: int = 10,
) -> dict[str, torch.Tensor]:
    """Per-bucket tensors of shape (num_buckets,): mean CE, mean prediction
    entropy and masked-token counts. Rows are bucketed by their masked
    fraction; empty buckets report 0."""
    ce, valid = masked_cross_entropy(logits, labels)
    active = masked_indices & valid

    logp = F.log_softmax(logits.float(), dim=-1)
    entropy = -(logp.exp() * logp).sum(dim=-1)                   # (B, L)

    ratios = masked_indices.float().mean(dim=1)                  # (B,)
    bucket_of = (ratios * num_buckets).to(torch.int32).clamp(0, num_buckets - 1)
    onehot = F.one_hot(bucket_of.long(), num_buckets).float()   # (B, K)

    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    row_ce = torch.where(active, ce, zero).sum(dim=1)
    row_entropy = torch.where(active, entropy, zero).sum(dim=1)
    row_count = active.sum(dim=1).float()

    bucket_count = onehot.T @ row_count
    safe = bucket_count.clamp(min=1.0)
    return {
        "bucket_ce": (onehot.T @ row_ce) / safe,
        "bucket_entropy": (onehot.T @ row_entropy) / safe,
        "bucket_tokens": bucket_count,
    }
