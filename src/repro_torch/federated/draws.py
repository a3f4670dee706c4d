"""Where a round's random draws come from.

The reference derives every draw of round ``rnd`` from
``fold_in(key(seed), rnd)`` with ``jax.random``; torch's generators give
other numbers from the same seed.  So the engine takes its draws from a
:class:`Draws` object.  :class:`TorchDraws` is the one the package
ships; a test can hand the engine another implementation that replays
the reference's draws, which is how the port is held to the reference
trajectory for trajectory.
"""
from __future__ import annotations

from typing import Protocol

import torch

from repro_torch.federated.sampler import sample_clients

_MASK64 = (1 << 64) - 1


class Draws(Protocol):
    """The random draws of one round ``rnd`` (1-based)."""

    def select(self, rnd: int, num_clients: int, n: int) -> torch.Tensor:
        """Sorted ``[n]`` int64 indices of the round's clients."""

    def batch_plans(self, rnd: int, counts_sel: torch.Tensor, steps: int,
                    batch_size: int) -> torch.Tensor:
        """``[S, steps, batch_size]`` int64 row indices, each drawn
        uniformly with replacement below the client's ``counts_sel[s]``."""


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class TorchDraws:
    """Draws from ``torch.Generator``s on ``device``, one per (round, use).

    Each round's generator is seeded from ``(seed, rnd, use)`` alone, so a
    round's draws do not depend on the rounds before it, as in the
    reference.
    """

    def __init__(self, seed: int, device: torch.device | str = "cuda"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _generator(self, rnd: int, use: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        mixed = _splitmix64(_splitmix64(_splitmix64(self.seed) ^ rnd) ^ use)
        g.manual_seed(mixed >> 1)           # a non-negative 63-bit seed
        return g

    def select(self, rnd: int, num_clients: int, n: int) -> torch.Tensor:
        return sample_clients(self._generator(rnd, 0), num_clients, n)

    def batch_plans(self, rnd: int, counts_sel: torch.Tensor, steps: int,
                    batch_size: int) -> torch.Tensor:
        n = torch.clamp(counts_sel.to(self.device, torch.int64), min=1)
        u = torch.rand((n.shape[0], steps, batch_size),
                       generator=self._generator(rnd, 1), device=self.device)
        idx = (u * n[:, None, None].to(torch.float32)).to(torch.int64)
        return torch.minimum(idx, n[:, None, None] - 1)
