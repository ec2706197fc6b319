"""Fused-vocabulary layout for the unified multimodal token space.

The reference scatters its vocabulary constants across files (reserved ids in
training/prompting_utils.py:17-33, mask id hardcoded as 126336 in
generate.py:45 / models/modeling_mmada.py:131, the image-token offset
hardcoded as 126349 in app.py:396, sizes in configs/mmada_demo.yaml:19-22).
Here the whole layout lives in one immutable object that every component —
prompting, samplers, losses, serving — receives explicitly.

Layout of the fused token space (sizes for the 8B flagship):

    [0, text_vocab)                 text tokens (LLaDA tokenizer, ~126,349 live)
      .. reserved ids 126,084-126,097 (task/markers), [MASK]=126,336
    [text_vocab, +image_codebook)   MAGVIT-v2 LFQ codes  (8,192)
    [.., +motion_codebook)          motion VQ codes      (512, optional)
    [.., +2]                        motion EOM / PAD     (optional)

`text_vocab` is the *padded* llm vocab size (126,464), so the image window
starts there, matching reference semantics where image ids are offset by
`len(text_tokenizer)` after special-token additions (inference_mmu.py:87).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Reserved special token ids (reference: training/prompting_utils.py:17-33).
RESERVED_TOKENS = {
    "<|soi|>": 126084,
    "<|eoi|>": 126085,
    "<|sov|>": 126086,
    "<|eov|>": 126087,
    "<|t2i|>": 126088,
    "<|mmu|>": 126089,
    "<|t2v|>": 126090,
    "<|v2v|>": 126091,
    "<|lvg|>": 126092,
    "[iPAD]": 126093,
    "<|r2i|>": 126094,
    "<|t2m|>": 126095,
    "<|som|>": 126096,
    "<|eom|>": 126097,
}

MASK_TOKEN_ID = 126336  # reference: generate.py:45, modeling_mmada.py:131


@dataclasses.dataclass(frozen=True)
class VocabLayout:
    """Single source of truth for the fused discrete token space."""

    text_vocab_size: int = 126464          # padded llm_vocab_size
    image_codebook_size: int = 8192        # MAGVIT-v2 LFQ 2^13
    motion_codebook_size: int = 0          # motion VQ (512 when enabled)
    motion_special: int = 0                # EOM/PAD rows appended after motion
    mask_token_id: int = MASK_TOKEN_ID
    pad_token_id: int = RESERVED_TOKENS["[iPAD]"]
    bos_token_id: int = 126080             # LLaDA tokenizer <|startoftext|>
    eos_token_id: int = 126081             # LLaDA tokenizer <|endoftext|>

    # ------------------------------------------------------------------ sizes
    @property
    def image_offset(self) -> int:
        """First fused id of the image VQ window."""
        return self.text_vocab_size

    @property
    def motion_offset(self) -> int:
        """First fused id of the motion VQ window."""
        return self.text_vocab_size + self.image_codebook_size

    @property
    def total_vocab_size(self) -> int:
        """Rows in the fused embedding table (reference `new_vocab_size`)."""
        return (
            self.text_vocab_size
            + self.image_codebook_size
            + self.motion_codebook_size
            + self.motion_special
        )

    # --------------------------------------------------------------- windows
    @property
    def image_window(self) -> tuple[int, int]:
        """[start, stop) fused-id window of image VQ codes."""
        return (self.image_offset, self.image_offset + self.image_codebook_size)

    @property
    def motion_window(self) -> tuple[int, int]:
        start = self.motion_offset
        return (start, start + self.motion_codebook_size + self.motion_special)

    # -------------------------------------------------------------- helpers
    def special(self, name: str) -> int:
        return RESERVED_TOKENS[name]

    def image_to_fused(self, vq_ids):
        """Map raw VQ codes [0, codebook) to fused ids."""
        return vq_ids + self.image_offset

    def fused_to_image(self, fused_ids):
        """Map fused ids back to raw VQ codes."""
        return fused_ids - self.image_offset

    def motion_to_fused(self, vq_ids):
        return vq_ids + self.motion_offset

    def fused_to_motion(self, fused_ids):
        return fused_ids - self.motion_offset

    # ------------------------------------------------------------- variants
    def with_motion(self, codebook_size: int = 512, special: int = 2) -> "VocabLayout":
        """Extended layout for the text-to-motion model family
        (reference: models/modelling_ours.py:106-123 auto vocab computation)."""
        return dataclasses.replace(
            self, motion_codebook_size=codebook_size, motion_special=special
        )


# Flagship 8B layout: 126,464 + 8,192 = 134,656 (configs/mmada_demo.yaml:19-22).
MMADA_8B = VocabLayout()

# t2m extension: +512 motion codes +2 (EOM, PAD) = 135,170
# (reference: training/train_t2m.py:516-520 vocab log).
MMADA_8B_T2M = MMADA_8B.with_motion()


def tiny_layout(
    text_vocab_size: int = 256,
    image_codebook_size: int = 64,
    motion_codebook_size: int = 0,
    motion_special: int = 0,
    mask_token_id: Optional[int] = None,
) -> VocabLayout:
    """Small layout for unit tests; mask id defaults to last text id."""
    return VocabLayout(
        text_vocab_size=text_vocab_size,
        image_codebook_size=image_codebook_size,
        motion_codebook_size=motion_codebook_size,
        motion_special=motion_special,
        mask_token_id=(
            text_vocab_size - 1 if mask_token_id is None else mask_token_id
        ),
        pad_token_id=text_vocab_size - 2,
        bos_token_id=1,
        eos_token_id=2,
    )
