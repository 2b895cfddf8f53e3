"""Device placement for the port's entry points: the card unless the caller
asks for the CPU. Nothing quietly continues on the CPU when CUDA is
missing."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; an
    explicit device (``"cpu"``, ``"cuda:0"``) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
