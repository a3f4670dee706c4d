"""Byzantine fault injection on the flat client matrix.

Counterpart of ``repro.federated.attacks``.  The reference attacks a
client's update ``delta = w_k - w_G`` leaf by leaf, elementwise, before
its flat path ravels; the port keeps the round's client models as one
``[S, N]`` matrix and attacks its rows, which computes the same values.

* static attacks, one payload per client from its own update:
  ``sign-flip`` (``-scale * delta``), ``scale`` (``scale * delta``) and
  ``random`` (``scale * N(0, I)``);
* colluding attacks, crafted from the corrupt cohort's pooled honest
  updates (:func:`cohort_stats`): ``colluding-alie`` (the estimated
  honest mean shifted by ``scale`` standard deviations, plus unit-sigma
  jitter) and ``colluding-flip`` (``-scale`` times the mean).

The random numbers of ``random`` and ``colluding-alie`` are an input
(``noise``, ``[S, N]`` standard normals from the round's ``Draws``), so
a test can hand both packages the same ones.  Honest rows pass through
bit for bit: the attacked matrix is ``where(corrupt, g + bad, trained)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.federated.draws import seeded_generator

AttackFn = Callable[[torch.Tensor, float, Optional[torch.Tensor]],
                    torch.Tensor]
CollusionFn = Callable[[float, Optional[torch.Tensor], torch.Tensor,
                        torch.Tensor], torch.Tensor]

#: jitter multiplier of ``colluding-alie`` (``attacks.py:108`` in the
#: reference): without it the colluders would sit at one point, mutually
#: distance-zero, and Krum would score them best.
ALIE_JITTER = 1.0

#: attacks whose payload needs the round's ``[S, N]`` noise
NOISY = ("random", "colluding-alie")


def sign_flip(delta: torch.Tensor, scale: float,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``delta' = -scale * delta``: push the commit against the cohort."""
    return -scale * delta


def scale_attack(delta: torch.Tensor, scale: float,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``delta' = scale * delta``: an oversized, correctly aimed update."""
    return scale * delta


def random_noise(delta: torch.Tensor, scale: float,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``delta' = scale * noise``: a garbage update."""
    return scale * noise


#: static attack name -> ``fn(delta, scale, noise) -> corrupted delta``
ATTACKS: Dict[str, AttackFn] = {
    "sign-flip": sign_flip,
    "scale": scale_attack,
    "random": random_noise,
}


def colluding_alie(scale: float, noise: Optional[torch.Tensor],
                   mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``delta' = mu - scale*sigma + sigma*noise`` ("A Little Is Enough",
    Baruch et al., 2019): inside the band a coordinate-wise trim keeps,
    yet biasing it by ``O(scale * sigma)`` every round."""
    return mu - scale * sigma + ALIE_JITTER * sigma * noise


def colluding_flip(scale: float, noise: Optional[torch.Tensor],
                   mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``delta' = -scale * mu``: the negated estimated honest mean."""
    return -scale * mu


#: colluding attack name -> ``fn(scale, noise, mu, sigma) -> payload``
COLLUDING: Dict[str, CollusionFn] = {
    "colluding-alie": colluding_alie,
    "colluding-flip": colluding_flip,
}


def is_colluding(name: str) -> bool:
    """True iff ``name`` is an adaptive (cohort-statistics) attack."""
    return name in COLLUDING


def get_attack(name: str) -> AttackFn:
    if name not in ATTACKS:
        raise KeyError(f"unknown attack {name!r}; available: "
                       f"{sorted(ATTACKS)}")
    return ATTACKS[name]


def get_colluding(name: str) -> CollusionFn:
    if name not in COLLUDING:
        raise KeyError(f"unknown colluding attack {name!r}; available: "
                       f"{sorted(COLLUDING)}")
    return COLLUDING[name]


def validate_attack(name: str) -> None:
    """Fail fast unless ``name`` is a known static or colluding attack."""
    if not is_colluding(name):
        get_attack(name)


def cohort_stats(delta: torch.Tensor, corrupt: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate mean and std ``([N], [N])`` of the rows of ``delta``
    (``[S, N]`` updates) flagged in ``corrupt`` (``[S]`` 0/1)."""
    c = corrupt.to(torch.float32)[:, None]
    denom = torch.clamp(c.sum(), min=1.0)
    s1 = (c * delta).sum(dim=0)
    s2 = (c * delta * delta).sum(dim=0)
    mu = s1 / denom
    var = torch.clamp(s2 / denom - mu * mu, min=0.0)
    return mu, torch.sqrt(var)


def _swap_in(trained: torch.Tensor, global_vec: torch.Tensor,
             corrupt: torch.Tensor, bad_delta: torch.Tensor) -> torch.Tensor:
    is_bad = (corrupt > 0)[:, None]
    return torch.where(is_bad, global_vec[None, :] + bad_delta, trained)


def apply_attack(name: str, trained: torch.Tensor, global_vec: torch.Tensor,
                 corrupt: torch.Tensor, scale: float,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The round's ``[S, N]`` client models with the rows flagged in
    ``corrupt`` replaced by ``g + attack(w_k - g)``."""
    fn = get_attack(name)
    bad = fn(trained - global_vec[None, :], scale, noise)
    return _swap_in(trained, global_vec, corrupt, bad)


def apply_colluding_attack(name: str, trained: torch.Tensor,
                           global_vec: torch.Tensor, corrupt: torch.Tensor,
                           scale: float, noise: Optional[torch.Tensor],
                           mu: torch.Tensor,
                           sigma: torch.Tensor) -> torch.Tensor:
    """The round's ``[S, N]`` client models with the flagged rows replaced
    by ``g + payload(mu, sigma)``."""
    bad = get_colluding(name)(scale, noise, mu, sigma)
    return _swap_in(trained, global_vec, corrupt, bad)


def corrupt_fleet(fleet, frac: float, attack: str = "sign-flip",
                  scale: float = 1.0, seed: int = 0):
    """A copy of ``fleet`` with ``ceil(frac * K)`` clients, drawn uniformly
    from ``seed``, flagged corrupt and the attack recorded; ``frac = 0``
    clears the flags."""
    validate_attack(attack)
    k = fleet.num_clients
    m = int(math.ceil(frac * k))
    if not 0 <= m <= k:
        raise ValueError(f"corrupt fraction {frac} out of range for K={k}")
    if m == 0:
        return dataclasses.replace(fleet, corrupt=None)
    perm = torch.randperm(k, generator=seeded_generator(seed, 0xC0))
    mask = torch.zeros(k, dtype=torch.float32)
    mask[perm[:m]] = 1.0
    return dataclasses.replace(fleet, corrupt=mask.to(fleet.tier.device),
                               attack=attack, attack_scale=float(scale))
