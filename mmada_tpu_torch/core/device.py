"""Device resolution for the port's entry points.

The port runs on the card. A caller that wants the CPU (the tests) says so;
without CUDA and without an explicit device the entry points raise instead
of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card: CUDA device 0, or an error if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mmada_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)
