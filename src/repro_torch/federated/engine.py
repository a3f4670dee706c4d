"""Round-engine core: the server's carry and the synchronous strategy.

Counterpart of the sync path of ``repro.federated.engine``:

* :class:`ServerState` — what the server remembers between rounds: the
  flat global model, each client's last committed round, the virtual
  clock and the commit count,
* :class:`RoundInputs` — what one round produced on the client side,
* :class:`AggregationStrategy` — the protocol a policy implements, and
  :class:`SyncStrategy`, the paper's synchronous round.

The server keeps the flat representation: ``params`` is the ``[N]`` f32
global vector and ``RoundInputs.stacked`` the round's ``[S, N]`` client
matrix, so the commit is one streaming reduction (the ``weighted_agg``
CUDA kernel on the GPU).  Every value stays on the device; nothing here
waits for it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import torch

from repro_torch.core.aggregate import (AggregationConfig, aggregate_models,
                                        compute_weights)


@dataclass
class ServerState:
    """The engine's carry (``K`` = fleet size, ``N`` = model size).

    * ``params``    — global model ``w_G``, flat ``[N]`` f32
    * ``last_sync`` — ``[K]`` int32, round of each client's last
      committed sync
    * ``sim_time``  — virtual clock, f32 scalar (time units)
    * ``commits``   — global updates committed so far, int32 scalar
    """

    params: torch.Tensor
    last_sync: torch.Tensor
    sim_time: torch.Tensor
    commits: torch.Tensor


@dataclass
class RoundInputs:
    """One round's client-side products, handed to the strategy.

    ``mask`` is binary participation; ``contrib`` (mask down-weighted for
    stragglers) is what the aggregation weights see.  An all-zero
    ``mask`` round is a no-op.
    """

    rnd: int                # round id (1-based)
    sel: torch.Tensor       # [S] selected client indices
    stacked: torch.Tensor   # [S, N] locally-trained client models
    criteria: torch.Tensor  # [S, m] normalized criteria matrix
    mask: torch.Tensor      # [S] binary participation
    contrib: torch.Tensor   # [S] mask / slowdown
    dt: torch.Tensor        # [S] virtual completion times (time units)


def _scatter_round(last_sync: torch.Tensor, sel: torch.Tensor,
                   mask: torch.Tensor, rnd: int,
                   gate: torch.Tensor) -> torch.Tensor:
    """``last_sync[sel] = rnd`` where ``mask`` and ``gate`` hold (a new
    tensor; ``sel`` holds distinct indices)."""
    upd = torch.where(gate * mask > 0,
                      torch.full_like(last_sync[sel], rnd), last_sync[sel])
    out = last_sync.clone()
    out[sel] = upd
    return out


def _entropy(p: torch.Tensor) -> torch.Tensor:
    return -(p * torch.log(torch.clamp(p, min=1e-12))).sum()


class AggregationStrategy:
    """Protocol: how a round's client products become a server update."""

    def init_state(self, params: torch.Tensor,
                   num_clients: int) -> ServerState:
        dev = params.device
        return ServerState(
            params=params,
            last_sync=torch.zeros(num_clients, dtype=torch.int32, device=dev),
            sim_time=torch.zeros((), dtype=torch.float32, device=dev),
            commits=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step(self, state: ServerState, inp: RoundInputs,
             cfg: AggregationConfig
             ) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
        """Fold one round's client products into the carry; returns the
        new carry and the round's metrics (``entropy`` of the weights)."""
        raise NotImplementedError


class SyncStrategy(AggregationStrategy):
    """The paper's synchronous round: aggregate every participant now.

    If every selected client dropped out the round is a no-op (the model
    is kept, the clock advances one unit); otherwise the round lasts the
    straggler barrier ``max_k dt_k`` over participants.
    """

    def step(self, state, inp, cfg):
        p = compute_weights(inp.criteria, cfg, tuple(cfg.priority),
                            mask=inp.contrib)
        new_params = aggregate_models(inp.stacked, p)
        alive = inp.contrib.sum() > 0
        new_params = torch.where(alive, new_params, state.params)
        barrier = (inp.dt * inp.mask).max()       # wait for stragglers
        new_state = replace(
            state,
            params=new_params,
            last_sync=_scatter_round(state.last_sync, inp.sel, inp.mask,
                                     inp.rnd, alive.to(torch.float32)),
            sim_time=state.sim_time + torch.where(alive, barrier, 1.0),
            commits=state.commits + alive.to(torch.int32),
        )
        return new_state, {"entropy": _entropy(p)}
