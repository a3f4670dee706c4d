"""Multi-criteria aggregation operators (paper §2.2).

Counterpart of ``repro.core.operators``: the prioritized operator
(paper Eq. 4), the weighted average, OWA and the Choquet integral.
Every operator maps a criteria matrix ``c[K, m]`` (entries in [0, 1]) to
a score vector ``s[K]``; :func:`scores_to_weights` normalizes scores
into aggregation weights ``p[K]`` with ``sum(p) == 1`` (paper Eq. 3).
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

Permutation = Tuple[int, ...]


def all_permutations(m: int) -> Tuple[Permutation, ...]:
    """All priority orders over ``m`` criteria (m! of them), in the
    reference's (``itertools``) order."""
    return tuple(itertools.permutations(range(m)))


def prioritized_score(c: torch.Tensor, priority: Permutation) -> torch.Tensor:
    """Prioritized multi-criteria score (paper Eq. 4).

    ``priority`` lists criteria indices from the most important to the
    least.  With ``lambda_1 = 1`` and ``lambda_i = lambda_{i-1} c_(i-1)``,
    ``s = sum_i lambda_i c_(i)``: an unfulfilled high-priority criterion
    attenuates everything below it.
    """
    squeeze = c.dim() == 1
    if squeeze:
        c = c.unsqueeze(0)
    ordered = c[:, list(priority)]                    # most→least important
    lam = torch.cat([torch.ones_like(ordered[:, :1]),
                     torch.cumprod(ordered[:, :-1], dim=1)], dim=1)
    s = (lam * ordered).sum(dim=1)
    return s[0] if squeeze else s


def weighted_average_score(c: torch.Tensor,
                           importance: torch.Tensor) -> torch.Tensor:
    """Fixed-importance weighted mean: ``s = c @ w / sum(w)``."""
    w = torch.as_tensor(importance, dtype=c.dtype, device=c.device)
    return c @ (w / w.sum())


def owa_score(c: torch.Tensor, owa_weights: torch.Tensor) -> torch.Tensor:
    """OWA (Yager 1988): weights apply to criteria sorted descending."""
    squeeze = c.dim() == 1
    if squeeze:
        c = c.unsqueeze(0)
    w = torch.as_tensor(owa_weights, dtype=c.dtype, device=c.device)
    w = w / w.sum()
    s = torch.sort(c, dim=1, descending=True).values @ w
    return s[0] if squeeze else s


def owa_quantifier_weights(m: int, alpha: float) -> torch.Tensor:
    """RIM-quantifier OWA weights ``w_i = Q(i/m) - Q((i-1)/m)``, Q(x)=x^alpha."""
    q = (torch.arange(m + 1, dtype=torch.float32) / m) ** alpha
    return q[1:] - q[:-1]


def lambda_fuzzy_measure(singletons: Sequence[float],
                         lam: float) -> torch.Tensor:
    """Dense Sugeno lambda-measure ``mu[2**m]`` indexed by subset bitmask,
    normalized so the full set has measure 1."""
    m = len(singletons)
    mu = [0.0] * (1 << m)
    for mask in range(1, 1 << m):
        lo = mask & (mask - 1)             # mask without its lowest set bit
        g = float(singletons[(mask ^ lo).bit_length() - 1])
        mu[mask] = mu[lo] + g + lam * mu[lo] * g
    arr = torch.tensor(mu, dtype=torch.float32)
    return arr / max(mu[(1 << m) - 1], 1e-12)


def choquet_score(c: torch.Tensor, measure: torch.Tensor) -> torch.Tensor:
    """Discrete Choquet integral of ``c[K, m]`` w.r.t. subset measure ``mu``.

    ``C(c) = sum_i (c_(i) - c_(i-1)) mu(A_i)`` with ``c_(i)`` ascending
    and ``A_i`` the criteria whose value is ``>= c_(i)``.
    """
    squeeze = c.dim() == 1
    if squeeze:
        c = c.unsqueeze(0)
    c_sorted, order = torch.sort(c, dim=1, stable=True)     # ascending
    prev = torch.cat([torch.zeros_like(c_sorted[:, :1]), c_sorted[:, :-1]],
                     dim=1)
    bits = torch.bitwise_left_shift(torch.ones_like(order), order)
    suffix = torch.flip(torch.cumsum(torch.flip(bits, [1]), dim=1), [1])
    mu = torch.as_tensor(measure, device=c.device)[suffix]
    s = ((c_sorted - prev) * mu).sum(dim=1)
    return s[0] if squeeze else s


def scores_to_weights(s: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``p^k = s^k / Z`` with ``Z = sum_k s^k`` (paper Eq. 3); uniform if
    every score is ~0, so a degenerate round never divides by zero."""
    s = s.to(torch.float32)
    z = s.sum()
    uniform = torch.full_like(s, 1.0 / s.shape[0])
    return torch.where(z > eps, s / torch.clamp(z, min=eps), uniform)

