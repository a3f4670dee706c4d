"""Server-side aggregation: criteria → weights → weighted model average.

Counterpart of ``repro.core.aggregate`` (paper Eqs. 2–4): one score per
client from an aggregation operator, scores normalized into weights
``p^k``, and the commit ``w_G = sum_k p^k w^k``.  The port keeps the
server's models in the flat representation only: the commit is one
``[K, N]`` weighted reduction, the hand-written ``weighted_agg`` CUDA
kernel on the GPU (``kernels.ops.flat_weighted_agg``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import operators
from repro_torch.core.operators import Permutation
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class AggregationConfig:
    """Configuration of the multi-criteria aggregation step."""

    criteria: Tuple[str, ...] = ("Ds", "Ld", "Md")
    operator: str = "prioritized"
    # operator parameters; `priority` indexes into `criteria`
    priority: Permutation = (0, 1, 2)
    importance: Optional[Tuple[float, ...]] = None   # weighted_average
    owa_alpha: float = 2.0                           # owa quantifier
    choquet_lambda: float = -0.5                     # choquet capacity
    choquet_singletons: Optional[Tuple[float, ...]] = None

    def num_criteria(self) -> int:
        return len(self.criteria)


def compute_scores(c: torch.Tensor, cfg: AggregationConfig,
                   priority: Optional[Permutation] = None) -> torch.Tensor:
    """Criteria matrix ``[K, m]`` → raw scores ``[K]`` under ``cfg``."""
    m = c.shape[-1]
    if cfg.operator == "prioritized":
        return operators.prioritized_score(c, priority or cfg.priority)
    if cfg.operator == "weighted_average":
        imp = cfg.importance or (1.0,) * m
        return operators.weighted_average_score(c, torch.tensor(imp))
    if cfg.operator == "owa":
        w = operators.owa_quantifier_weights(m, cfg.owa_alpha)
        return operators.owa_score(c, w)
    if cfg.operator == "choquet":
        singles = cfg.choquet_singletons or (1.0 / m,) * m
        mu = operators.lambda_fuzzy_measure(singles, cfg.choquet_lambda)
        return operators.choquet_score(c, mu)
    raise KeyError(f"unknown operator {cfg.operator!r}")


def compute_weights(c: torch.Tensor, cfg: AggregationConfig,
                    priority: Optional[Permutation] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Criteria → normalized aggregation weights ``p[K]`` (Eq. 3).

    ``mask`` scales scores before normalization: 0 excludes a client,
    values in (0, 1) down-weight it.  The all-zero-score fallback is
    uniform over participants only; with no mask this is
    :func:`operators.scores_to_weights`.
    """
    s = compute_scores(c, cfg, priority)
    if mask is None:
        return operators.scores_to_weights(s)
    m = mask.to(s.dtype)
    s = s * m
    z = s.sum()
    participants = (m > 0).to(s.dtype)
    uniform = participants / torch.clamp(participants.sum(), min=1.0)
    eps = 1e-12
    return torch.where(z > eps, s / torch.clamp(z, min=eps), uniform)


def aggregate_models(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """``w_G = sum_k p_k w_k`` over the flat ``[K, N]`` client matrix."""
    if not (isinstance(stacked, torch.Tensor) and stacked.dim() == 2):
        raise NotImplementedError(
            "the port aggregates the flat [K, N] representation only; the "
            "per-leaf pytree path is not ported yet")
    return kops.flat_weighted_agg(stacked, weights)
