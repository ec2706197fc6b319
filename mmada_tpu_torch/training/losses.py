"""Multi-task masked-diffusion losses: one forward, three weighted CE terms.

Counterpart of `mmada_tpu/training/losses.py` (:35-335). The train batch is
a concat `[t2i rows | lm rows | mmu rows]`; one backbone forward gives the
hidden states, and

  * t2i - mean CE over the image span (positions > max_seq_length) with
    ignore index -100;
  * lm  - LLaDA estimator: sum over masked CE / p_mask / (B L); with answer
    lengths (chat SFT): sum CE / (p_mask answer_len) / B, or the reference's
    stage-3 compounding formula with `mode="reference_stage3"`;
  * mmu - sum over masked CE / (p_mask answer_len) / B.

Stage 4 adds an r2i segment (`forward_process_with_r2i`); predict-all-tokens
training weighs the t2i span (`get_loss_weight`, `weighted_t2i_loss`); the
class-conditional path takes soft targets (`soft_target_cross_entropy`).

With `loss_chunk > 0` the vocab head runs one position chunk at a time under
`torch.utils.checkpoint` (the `jax.checkpoint` scan of the JAX package), so
the `(B, L, V)` logits never exist whole: every loss here is linear in the
per-position CE, so the objective is three weighted sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE_ID = -100


def masked_cross_entropy(
    logits: torch.Tensor,   # (B, L, V)
    labels: torch.Tensor,   # (B, L) int, IGNORE_ID to skip
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position CE in fp32 and the validity mask; ignored positions
    give 0."""
    valid = labels != IGNORE_ID
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, ce, torch.zeros_like(ce)), valid


def t2i_loss(logits, labels, max_seq_length: int) -> torch.Tensor:
    """Mean CE over the image span."""
    ce, valid = masked_cross_entropy(logits[:, max_seq_length + 1:],
                                     labels[:, max_seq_length + 1:])
    return ce.sum() / torch.clamp(valid.sum(), min=1)


def lm_loss(logits, labels, masked_indices, p_mask,
            answer_lengths: Optional[torch.Tensor] = None,
            mode: str = "llada") -> torch.Tensor:
    b, l = labels.shape
    ce, valid = masked_cross_entropy(logits, labels)
    active = masked_indices & valid
    zero = torch.zeros_like(ce)
    weighted = torch.where(active, ce / p_mask, zero)
    if answer_lengths is None:
        return weighted.sum() / (b * l)
    if mode == "reference_stage3":
        scalar = weighted.sum() / (b * l)
        inv_len = torch.where(active, 1.0 / answer_lengths, zero)
        return scalar * inv_len.sum() / b
    return torch.where(active, weighted / answer_lengths, zero).sum() / b


def answer_loss(logits, labels, masked_indices, p_mask, answer_lengths) -> torch.Tensor:
    """mmu loss: sum CE / (p len) / B."""
    ce, valid = masked_cross_entropy(logits, labels)
    active = masked_indices & valid
    return torch.where(active, ce / (p_mask * answer_lengths),
                       torch.zeros_like(ce)).sum() / labels.shape[0]


def t2m_loss(logits, labels, masked_indices, p_mask, answer_lengths) -> torch.Tensor:
    """Motion loss with the mmu normalization (modelling_ours.py:323-395,
    the forward_process t2m branch)."""
    return answer_loss(logits, labels, masked_indices, p_mask, answer_lengths)


def chunked_weighted_ce(
    model,
    normed_hidden: torch.Tensor,  # (B, L, D) post-final-norm
    labels: torch.Tensor,         # (B, L) int, IGNORE_ID to skip
    weights: torch.Tensor,        # (T, B, L) fp32 per-task position weights
    chunk_size: int,
) -> torch.Tensor:
    """(T,) sums of weights[t] * CE over positions, applying the vocab head
    one position chunk at a time; the backward recomputes each chunk's
    logits (checkpoint), so one `(B, chunk, V)` tile is alive at a time."""

    def chunk_sums(h_c, l_c, w_c):
        ce, _ = masked_cross_entropy(model.apply_head(h_c), l_c)
        return torch.einsum("tbc,bc->t", w_c, ce)

    sums = torch.zeros(weights.shape[0], dtype=torch.float32, device=normed_hidden.device)
    for start in range(0, normed_hidden.shape[1], chunk_size):
        stop = start + chunk_size
        sums = sums + checkpoint(
            chunk_sums, normed_hidden[:, start:stop], labels[:, start:stop],
            weights[:, :, start:stop], use_reentrant=False,
        )
    return sums


def forward_process(
    model,
    input_ids: torch.Tensor,   # (Bt+Bl+Bm, L) fused tokens, corrupted
    labels: torch.Tensor,      # same shape, IGNORE_ID outside targets
    batch_size_t2i: int,
    batch_size_lm: int,
    batch_size_mmu: int,
    max_seq_length: int,
    p_mask_lm: Optional[torch.Tensor] = None,
    p_mask_mmu: Optional[torch.Tensor] = None,
    answer_lengths: Optional[torch.Tensor] = None,
    t2i_masks: Optional[torch.Tensor] = None,
    answer_lengths_lm: Optional[torch.Tensor] = None,
    lm_loss_mode: str = "llada",
    loss_chunk: int = 0,
    rows: Optional[torch.Tensor] = None,
):
    """Returns (logits, loss_t2i, loss_lm, loss_mmu); with `loss_chunk > 0`
    the logits slot is None (they are never materialised) and the losses are
    the same.

    `rows` (over a mesh: this rank's global row indices, `parallel/grads.py`)
    forwards those rows only; the weights are built on the whole batch, so
    each loss is the rows' share of the global one (summing the ranks'
    shares gives it), and the logits slot is None."""
    bt, bl, bm = batch_size_t2i, batch_size_lm, batch_size_mmu
    attention_mask = None
    if t2i_masks is not None and bt > 0:
        pad = torch.ones((bl + bm, input_ids.shape[1]), dtype=t2i_masks.dtype,
                         device=t2i_masks.device)
        attention_mask = torch.cat([t2i_masks, pad], dim=0)

    if rows is not None:
        weights, lm_factor = loss_weights(
            input_ids, labels, model.vocab.mask_token_id, bt, bl, bm, max_seq_length,
            p_mask_lm, p_mask_mmu, answer_lengths, answer_lengths_lm, lm_loss_mode)
        rows = rows.to(input_ids.device)
        mask = None if attention_mask is None else attention_mask[rows]
        hidden = model.forward_hidden(input_ids[rows], attention_mask=mask)
        sums = chunked_weighted_ce(model.with_whole_head(), hidden, labels[rows],
                                   weights[:, rows], loss_chunk or input_ids.shape[1])
        return None, sums[0], sums[1] * lm_factor, sums[2]

    if loss_chunk:
        return _forward_process_chunked(
            model, input_ids, labels, attention_mask, bt, bl, bm, max_seq_length,
            p_mask_lm, p_mask_mmu, answer_lengths, answer_lengths_lm,
            lm_loss_mode, loss_chunk,
        )

    hidden = model.forward_hidden(input_ids, attention_mask=attention_mask)
    logits = model.apply_head(hidden).float()
    masked = input_ids == model.vocab.mask_token_id
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    loss_t2i = t2i_loss(logits[:bt], labels[:bt], max_seq_length) if bt else zero
    loss_lm = (
        lm_loss(logits[bt:bt + bl], labels[bt:bt + bl], masked[bt:bt + bl],
                p_mask_lm, answer_lengths_lm, mode=lm_loss_mode)
        if bl else zero
    )
    loss_mmu = (
        answer_loss(logits[bt + bl:], labels[bt + bl:], masked[bt + bl:],
                    p_mask_mmu, answer_lengths)
        if bm else zero
    )
    return logits, loss_t2i, loss_lm, loss_mmu


def _forward_process_chunked(
    model, input_ids, labels, attention_mask, bt, bl, bm, max_seq_length,
    p_mask_lm, p_mask_mmu, answer_lengths, answer_lengths_lm, lm_loss_mode,
    loss_chunk,
):
    """The three tasks' per-position weight fields (none depends on the
    logits), then one `chunked_weighted_ce` pass."""
    weights, lm_factor = loss_weights(
        input_ids, labels, model.vocab.mask_token_id, bt, bl, bm, max_seq_length,
        p_mask_lm, p_mask_mmu, answer_lengths, answer_lengths_lm, lm_loss_mode)
    zero = torch.zeros((), dtype=torch.float32, device=input_ids.device)
    hidden = model.forward_hidden(input_ids, attention_mask=attention_mask)
    sums = chunked_weighted_ce(model, hidden, labels, weights, loss_chunk)
    return (
        None,
        sums[0] if bt else zero,
        sums[1] * lm_factor if bl else zero,
        sums[2] if bm else zero,
    )


def loss_weights(input_ids, labels, mask_id, bt, bl, bm, max_seq_length, p_mask_lm,
                 p_mask_mmu, answer_lengths, answer_lengths_lm, lm_loss_mode):
    """(weights (3, B, L), lm_factor): the t2i / lm / mmu per-position weights
    of the `[t2i | lm | mmu]` batch, whose CE-weighted sums are the three
    losses (the lm loss times `lm_factor`). The algebra is that of
    `t2i_loss` / `lm_loss` / `answer_loss`; every count is over the batch
    given."""
    b, l = input_ids.shape
    device = input_ids.device
    valid = labels != IGNORE_ID
    masked = input_ids == mask_id
    weights = torch.zeros((3, b, l), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    if bt:
        in_span = torch.arange(l, device=device) >= (max_seq_length + 1)
        span_valid = valid[:bt] & in_span[None, :]
        weights[0, :bt] = span_valid / torch.clamp(span_valid.sum(), min=1)

    lm_factor = torch.ones((), dtype=torch.float32, device=device)
    if bl:
        active = masked[bt:bt + bl] & valid[bt:bt + bl]
        base = torch.where(active, 1.0 / p_mask_lm, zero)
        if answer_lengths_lm is None:
            w1 = base / (bl * l)
        elif lm_loss_mode == "reference_stage3":
            # loss = (sum ce/p / (B L)) * (sum 1/len / B): the second factor
            # does not depend on the logits, so it is folded in after the sum
            w1 = base / (bl * l)
            lm_factor = torch.where(active, 1.0 / answer_lengths_lm, zero).sum() / bl
        else:
            w1 = torch.where(active, base / answer_lengths_lm, zero) / bl
        weights[1, bt:bt + bl] = w1

    if bm:
        active = masked[bt + bl:] & valid[bt + bl:]
        weights[2, bt + bl:] = torch.where(
            active, 1.0 / (p_mask_mmu * answer_lengths), zero) / bm
    return weights, lm_factor


def soft_target_cross_entropy(
    logits: torch.Tensor,        # (B, L, V)
    targets: torch.Tensor,       # (B, L) hard ids with IGNORE_ID padding
    soft_targets: torch.Tensor,  # (B, L-1, C) distributions over the first C classes
) -> torch.Tensor:
    """Soft-label CE skipping the first (class-id) token, averaged over the
    positions not padded (training/utils.py:53-69 of the reference)."""
    logits = logits[:, 1:, :soft_targets.shape[-1]]
    targets = targets[:, 1:]
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -(soft_targets * logp).sum(dim=-1)
    pad = targets == IGNORE_ID
    loss = torch.where(pad, torch.zeros_like(loss), loss)
    denom = torch.clamp((~pad).sum(), min=1)
    return loss.sum() / denom


def get_loss_weight(t: torch.Tensor, mask: torch.Tensor, min_val: float = 0.3) -> torch.Tensor:
    """Per-position loss weights of predict-all-tokens / random-replace
    training: unmasked positions decay toward `min_val` as the noise falls
    (training/utils.py:72-73 of the reference)."""
    return 1.0 - (1.0 - mask) * ((1.0 - t) * (1.0 - min_val))[:, None]


def weighted_t2i_loss(logits, labels, max_seq_length: int,
                      loss_weight: torch.Tensor) -> torch.Tensor:
    """The predict-all-tokens t2i loss: the weighted mean CE over the image
    span."""
    ce, valid = masked_cross_entropy(logits[:, max_seq_length + 1:],
                                     labels[:, max_seq_length + 1:])
    w = loss_weight.float()
    num = (ce * w * valid).sum()
    denom = torch.clamp((w * valid).sum(), min=1e-6)
    return num / denom


def forward_process_with_r2i(
    model,
    input_ids: torch.Tensor,     # [t2i | lm | mmu | r2i] rows
    labels: torch.Tensor,
    batch_size_t2i: int,
    batch_size_lm: int,
    batch_size_mmu: int,
    batch_size_r2i: int,
    max_seq_length: int,
    p_mask_lm=None,
    p_mask_mmu=None,
    p_mask_r2i=None,
    answer_lengths=None,
    answer_lengths_lm=None,
    answer_lengths_r2i=None,
    t2i_masks=None,
    lm_loss_mode: str = "llada",
):
    """Stage 4's variant with the r2i (reasoning-to-image) rows, normalised
    as mmu's: sum CE / (p len) / B (modeling_mmada.py:278-359 of the
    reference). Returns (logits, loss_t2i, loss_lm, loss_mmu, loss_r2i)."""
    bt, bl, bm, br = batch_size_t2i, batch_size_lm, batch_size_mmu, batch_size_r2i
    # t2i and lm through forward_process, its mmu segment off: its tail
    # slice would take the r2i rows too
    logits, loss_t2i, loss_lm, _ = forward_process(
        model, input_ids, labels, batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=0,
        max_seq_length=max_seq_length, p_mask_lm=p_mask_lm, t2i_masks=t2i_masks,
        answer_lengths_lm=answer_lengths_lm, lm_loss_mode=lm_loss_mode)
    masked = input_ids == model.vocab.mask_token_id
    r0 = bt + bl + bm
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    loss_mmu = (answer_loss(logits[bt + bl:r0], labels[bt + bl:r0], masked[bt + bl:r0],
                            p_mask_mmu, answer_lengths) if bm else zero)
    loss_r2i = (answer_loss(logits[r0:r0 + br], labels[r0:r0 + br], masked[r0:r0 + br],
                            p_mask_r2i, answer_lengths_r2i) if br else zero)
    return logits, loss_t2i, loss_lm, loss_mmu, loss_r2i
