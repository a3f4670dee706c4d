"""Client-selection policies.

Counterpart of ``repro.federated.selection`` for the paper's uniform
draw.  A policy sees a :class:`SelectionContext` and returns
``(sel, dt)``: the sorted ``[n]`` client indices and, for a policy that
selected on completion times, those times (``None`` otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.federated.draws import Draws


@dataclass
class SelectionContext:
    """What a policy may inspect when drawing round ``rnd``.

    * ``draws``       the round engine's source of random draws
    * ``num_clients`` fleet size ``K``
    * ``n``           round size ``S``
    * ``rnd``         round id (1-based)
    """

    draws: Draws
    num_clients: int
    n: int
    rnd: int


class UniformPolicy:
    """FedAvg's uniform draw of ``n`` distinct clients."""

    def select(self, ctx: SelectionContext
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return ctx.draws.select(ctx.rnd, ctx.num_clients, ctx.n), None
