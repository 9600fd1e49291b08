"""The one rule for choosing a torch device in the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a torch.device; None means "cuda".

    A machine without a card raises here instead of decoding on the CPU:
    the CPU runs only for a caller that passes ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' "
            "to decode on the CPU"
        )
    return device
