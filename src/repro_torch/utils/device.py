"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str, owner: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The port's entry points default to ``"cuda"``: without a GPU they
    raise instead of quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner} runs on the GPU by default and no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev
