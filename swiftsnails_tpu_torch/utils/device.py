"""Where the port's entry points run.

``device=None`` means the card. There is no quiet fallback to the CPU: a run
that asked for the card and found none raises, so a CPU timing can never pass
for a GPU one. Tests and CPU runs pass ``device="cpu"`` explicitly, and every
kernel wrapper then takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if the requested card is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on an NVIDIA GPU (H100) and "
                "torch.cuda.is_available() is False here; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
