"""MMaDA on PyTorch and CUDA: the text, t2i and MMU serving paths (with the
MAGVIT-v2 image tokenizer) and the multi-task training step of the unified
masked-diffusion model, with its attention kernels (forward, and the dq /
dkv backward) and its int4 matmul written by hand for Hopper.

The package mirrors the module names of the JAX package `mmada_tpu` so that
each counterpart is easy to find, and keeps the JAX weight layout (`(in, out)`
matrices, layer-stacked `blocks[name][i]`). It imports `torch` and numpy
only. Entry points run on `cuda` unless the caller passes `device="cpu"`;
without CUDA and without an explicit device they raise.
"""

__version__ = "0.2.0"

from mmada_tpu_torch.core.vocab import VocabLayout  # noqa: F401
