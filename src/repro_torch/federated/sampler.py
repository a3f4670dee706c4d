"""Client sampling for each round of communication.

Counterpart of the uniform path of ``repro.federated.sampler``: the
paper draws a fixed fraction (10%) of the fleet uniformly without
replacement.
"""
from __future__ import annotations

import torch


def num_selected(num_clients: int, fraction: float) -> int:
    """Round size ``max(1, round(f * K))``, clamped to the fleet size."""
    return max(1, min(num_clients, int(round(fraction * num_clients))))


def sample_clients(generator: torch.Generator, num_clients: int,
                   n: int) -> torch.Tensor:
    """``min(n, K)`` distinct clients, sorted (int64), drawn uniformly as a
    truncated permutation on ``generator``'s device."""
    n = min(int(n), int(num_clients))
    perm = torch.randperm(num_clients, generator=generator,
                          device=generator.device)
    return torch.sort(perm[:n]).values
