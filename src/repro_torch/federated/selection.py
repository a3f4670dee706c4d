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
from repro_torch.federated.scenarios import DeviceFleet


@dataclass
class SelectionContext:
    """What a policy may inspect when drawing round ``rnd``.

    * ``draws``       the round engine's source of random draws
    * ``num_clients`` fleet size ``K``
    * ``n``           round size ``S``
    * ``rnd``         round id (1-based)
    * ``fleet``       the device fleet, or ``None`` without a scenario
      (policies must not read its ``corrupt`` flags)
    """

    draws: Draws
    num_clients: int
    n: int
    rnd: int
    fleet: Optional[DeviceFleet] = None


class UniformPolicy:
    """FedAvg's uniform draw of ``n`` distinct clients; it ignores the
    fleet."""

    def select(self, ctx: SelectionContext
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return ctx.draws.select(ctx.rnd, ctx.num_clients, ctx.n), None
