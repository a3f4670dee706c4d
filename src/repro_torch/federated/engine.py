"""Round-engine core: the server's carry and the synchronous strategies.

Counterpart of the synchronous strategies of ``repro.federated.engine``:

* :class:`ServerState` — what the server remembers between rounds: the
  flat global model, each client's last committed round, the virtual
  clock and the commit count,
* :class:`RoundInputs` — what one round produced on the client side,
* :class:`AggregationStrategy` — the protocol a policy implements;
  :class:`SyncStrategy`, the paper's synchronous round; and the robust
  rounds :class:`TrimmedMeanStrategy`, :class:`KrumStrategy` and
  :class:`MultiKrumStrategy`, reached by name through
  :func:`make_strategy`.

The server keeps the flat representation: ``params`` is the ``[N]`` f32
global vector and ``RoundInputs.stacked`` the round's ``[S, N]`` client
matrix, so each commit is one streaming reduction (a CUDA kernel on the
GPU).  Every value stays on the device; nothing here
waits for it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.aggregate import (AggregationConfig, aggregate_models,
                                        compute_weights)
from repro_torch.kernels import ops as kops


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
        new carry and the round's metrics (``entropy`` of the weights;
        Krum adds ``selected``, the clients it averaged)."""
        raise NotImplementedError


def _sync_commit(state: ServerState, inp: RoundInputs, p: torch.Tensor,
                 new_params: torch.Tensor
                 ) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
    """The synchronous round's bookkeeping around its reduction: keep the
    model when every upload dropped (the clock then advances one unit),
    else commit and charge the straggler barrier ``max_k dt_k``."""
    alive = inp.contrib.sum() > 0
    barrier = (inp.dt * inp.mask).max()
    new_state = replace(
        state,
        params=torch.where(alive, new_params, state.params),
        last_sync=_scatter_round(state.last_sync, inp.sel, inp.mask,
                                 inp.rnd, alive.to(torch.float32)),
        sim_time=state.sim_time + torch.where(alive, barrier, 1.0),
        commits=state.commits + alive.to(torch.int32),
    )
    return new_state, {"entropy": _entropy(p)}


class SyncStrategy(AggregationStrategy):
    """The paper's synchronous round: aggregate every participant now.

    If every selected client dropped out the round is a no-op (the model
    is kept, the clock advances one unit); otherwise the round lasts the
    straggler barrier ``max_k dt_k`` over participants.
    """

    def step(self, state, inp, cfg):
        p = compute_weights(inp.criteria, cfg, tuple(cfg.priority),
                            mask=inp.contrib)
        return _sync_commit(state, inp, p,
                            aggregate_models(inp.stacked, p))


@dataclass(frozen=True)
class TrimmedMeanStrategy(AggregationStrategy):
    """Byzantine-robust sync: coordinate-wise weighted trimmed mean.

    Per coordinate the ``trim`` largest and ``trim`` smallest client
    values are dropped and the rest combined by their renormalized Eq. 3
    weights (the ``trimmed_agg`` CUDA kernel on the GPU).  A dropped
    client keeps weight 0 but still occupies a value slot; size ``trim``
    for the round cohort ``S``: needs ``2 * trim < S``.
    """

    trim: int = 1

    supports_online_adjust = False

    def step(self, state, inp, cfg):
        S = int(inp.mask.shape[0])
        if not 0 <= 2 * self.trim < S:
            raise ValueError(
                f"TrimmedMeanStrategy needs 0 <= 2*trim < round size; "
                f"got trim={self.trim} for S={S}")
        p = compute_weights(inp.criteria, cfg, tuple(cfg.priority),
                            mask=inp.contrib)
        new_params = kops.flat_trimmed_agg(inp.stacked, p, self.trim)
        return _sync_commit(state, inp, p, new_params)


@dataclass(frozen=True)
class KrumStrategy(AggregationStrategy):
    """Distance-based Byzantine-robust sync: Krum / multi-Krum.

    Blanchard et al. (2017): each client scores the summed squared
    distances to its ``S - f - 2`` nearest cohort neighbours, and the
    ``m`` best-scored clients are averaged by their renormalized Eq. 3
    weights (``m = 1`` is Krum).  ``f = None`` is the largest admissible
    bound ``(S - 3) // 2``; ``f`` and ``m`` are checked against ``S`` at
    the first step.  Dropped uploads score ``+inf`` but still serve as
    neighbours.  The distances are the ``pairwise_sq_dists`` CUDA kernel
    on the GPU, the average the ``weighted_agg`` one.  The round's
    metrics carry the ``m`` averaged clients' indices as ``selected``.
    """

    f: Optional[int] = None
    m: Optional[int] = 1

    supports_online_adjust = False

    def _resolve(self, S: int) -> Tuple[int, int]:
        f = self.f if self.f is not None else max(0, (S - 3) // 2)
        if not (0 <= f and 2 * f + 2 < S):
            raise ValueError(
                f"KrumStrategy needs f < (S - 2) / 2; got f={f} for S={S}")
        m = self.m if self.m is not None else max(1, S - f - 2)
        if not 1 <= m <= S - f - 2:
            raise ValueError(
                f"KrumStrategy needs 1 <= m <= S - f - 2; got m={m} "
                f"for S={S}, f={f}")
        return f, m

    def step(self, state, inp, cfg):
        f, m = self._resolve(int(inp.mask.shape[0]))
        p = compute_weights(inp.criteria, cfg, tuple(cfg.priority),
                            mask=inp.contrib)
        new_params, scores = kops.flat_krum_agg(inp.stacked, p, f, m)
        state, ys = _sync_commit(state, inp, p, new_params)
        # the m clients averaged: lowest scores, ties to the lower index
        ys["selected"] = torch.sort(scores, stable=True).indices[:m]
        return state, ys


@dataclass(frozen=True)
class MultiKrumStrategy(KrumStrategy):
    """Multi-Krum: ``m = None`` resolves to ``S - f - 2``, every client
    whose score the Krum criterion trusts."""

    m: Optional[int] = None


#: the strategies this port carries, by the reference's registry names
STRATEGIES = {
    "sync": SyncStrategy,
    "trimmed-mean": TrimmedMeanStrategy,
    "krum": KrumStrategy,
    "multi-krum": MultiKrumStrategy,
}


def make_strategy(name: str, **kwargs) -> AggregationStrategy:
    """Strategy factory: ``make_strategy("trimmed-mean", trim=9)``."""
    if name not in STRATEGIES:
        raise KeyError(f"unknown or unported aggregation strategy {name!r}; "
                       f"available: {sorted(STRATEGIES)}")
    return STRATEGIES[name](**kwargs)
