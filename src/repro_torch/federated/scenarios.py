"""Device fleets: who is available, who straggles, who attacks.

Counterpart of ``repro.federated.scenarios`` for the presets this port
carries: ``uniform``, ``tiered-fleet``, ``byzantine`` and
``byzantine-colluding``.  A :class:`DeviceFleet` holds per-client device
profiles as ``[K]`` tensors; per round, for each selected client:

1. availability follows a periodic duty cycle: on iff
   ``(round + phase) mod period < duty * period``;
2. the upload is lost with the client's ``dropout_prob``;
3. a straggler's update is down-weighted by ``1 / slowdown``, and it
   finishes after ``base * slowdown * exp(jitter * eps)`` time units.

The round mask is ``avail * (1 - drop)``; the contribution, which the
aggregation weights see, is ``mask / slowdown``.  The random numbers of
steps 2 and 3 come from the round's ``Draws``; a fleet is sampled once
from ``ScenarioConfig.seed`` on a CPU generator and then moved to the
device, so one seed gives one fleet on every device.

The ``byzantine`` presets flag a fraction of the fleet corrupt (see
``federated.attacks``) and promote every attacker to the fastest tier
with perfect availability; the simulation injects the attack after
local training.  Selection never looks at ``corrupt``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.federated.attacks import corrupt_fleet, is_colluding
from repro_torch.federated.draws import seeded_generator
from repro_torch.utils.device import resolve_device

#: tier index -> straggler slowdown multiplier
TIER_SLOWDOWN = (1.0, 2.0, 4.0)

#: completion-time model ``dt = base * slowdown * exp(jitter * eps)``
COMPLETION_BASE = 1.0
COMPLETION_JITTER = 0.25

# The reference's other presets, which this port does not carry yet.
_NOT_PORTED = ("mobile-heavy", "flaky-network", "churn", "diurnal", "outage")


@dataclass(frozen=True)
class ScenarioConfig:
    """Named preset plus knobs; ``preset="uniform"`` is the identity
    fleet.  The hostile knobs are read by the ``byzantine`` presets."""

    preset: str = "uniform"
    period: int = 24               # availability schedule period (rounds)
    seed: int = 0                  # fleet sampling seed
    bias_sampling: bool = False    # not ported: raises
    corrupt_frac: float = 0.25     # fraction of clients flagged corrupt
    attack: str = "sign-flip"      # see federated.attacks
    attack_scale: float = 1.0      # attack magnitude (ALIE z-score)

    def __post_init__(self):
        if self.bias_sampling:
            raise NotImplementedError(
                "bias_sampling (BiasPolicy) is not ported to repro_torch yet")
        if self.preset in _NOT_PORTED:
            raise NotImplementedError(
                f"scenario preset {self.preset!r} is not ported to "
                f"repro_torch yet; ported: {sorted(PRESETS)}")


@dataclass
class DeviceFleet:
    """Per-client device profiles (``K`` clients, tensors on one device).

    * ``tier``         ``[K]`` int32, compute tier (0 = fastest)
    * ``slowdown``     ``[K]`` f32, straggler factor (>= 1)
    * ``dropout_prob`` ``[K]`` f32, per-round upload loss probability
    * ``duty_cycle``   ``[K]`` f32 in (0, 1], fraction of the period on
    * ``phase``        ``[K]`` int32, offset into the period
    * ``corrupt``      ``[K]`` f32 0/1 Byzantine flags, or ``None``; with
      the ``attack`` name and ``attack_scale``
    """

    tier: torch.Tensor
    slowdown: torch.Tensor
    dropout_prob: torch.Tensor
    duty_cycle: torch.Tensor
    phase: torch.Tensor
    period: int = 24
    corrupt: Optional[torch.Tensor] = None
    attack: str = "sign-flip"
    attack_scale: float = 1.0

    @property
    def num_clients(self) -> int:
        return int(self.tier.shape[0])

    def to(self, device: torch.device | str) -> "DeviceFleet":
        """A copy with every tensor on ``device``."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _slowdown(tier: torch.Tensor) -> torch.Tensor:
    return torch.tensor(TIER_SLOWDOWN, dtype=torch.float32)[tier.long()]


def _uniform(g: torch.Generator, n: int, cfg: ScenarioConfig) -> DeviceFleet:
    return DeviceFleet(
        tier=torch.zeros(n, dtype=torch.int32),
        slowdown=torch.ones(n, dtype=torch.float32),
        dropout_prob=torch.zeros(n, dtype=torch.float32),
        duty_cycle=torch.ones(n, dtype=torch.float32),
        phase=torch.zeros(n, dtype=torch.int32),
        period=cfg.period,
    )


def _tiered_fleet(g: torch.Generator, n: int,
                  cfg: ScenarioConfig) -> DeviceFleet:
    """Three compute tiers (50/30/20 %), reliability tracking the tier."""
    u = torch.rand(n, generator=g)
    tier = ((u > 0.5).to(torch.int32) + (u > 0.8).to(torch.int32))
    return DeviceFleet(
        tier=tier,
        slowdown=_slowdown(tier),
        dropout_prob=(0.02 * (1 + tier)).to(torch.float32),
        duty_cycle=(1.0 - 0.2 * tier).to(torch.float32),
        phase=torch.randint(0, cfg.period, (n,), generator=g,
                            dtype=torch.int32),
        period=cfg.period,
    )


def _byzantine(g: torch.Generator, n: int,
               cfg: ScenarioConfig) -> DeviceFleet:
    """Tiered fleet with ``corrupt_frac`` attackers, every one promoted to
    tier 0 with perfect availability."""
    fleet = corrupt_fleet(_tiered_fleet(g, n, cfg), cfg.corrupt_frac,
                          attack=cfg.attack, scale=cfg.attack_scale,
                          seed=cfg.seed)
    if fleet.corrupt is None:                      # corrupt_frac == 0
        return fleet
    bad = fleet.corrupt > 0
    tier = torch.where(bad, 0, fleet.tier).to(torch.int32)
    return dataclasses.replace(
        fleet, tier=tier, slowdown=_slowdown(tier),
        dropout_prob=torch.where(bad, 0.0, fleet.dropout_prob),
        duty_cycle=torch.where(bad, 1.0, fleet.duty_cycle))


def _byzantine_colluding(g: torch.Generator, n: int,
                         cfg: ScenarioConfig) -> DeviceFleet:
    """The ``byzantine`` fleet with a colluding attack (a static attack
    name is upgraded to ``colluding-alie``)."""
    attack = cfg.attack if is_colluding(cfg.attack) else "colluding-alie"
    return _byzantine(g, n, dataclasses.replace(cfg, attack=attack))


#: preset name -> fleet sampler ``(generator, num_clients, cfg)``
PRESETS: Dict[str, Callable[[torch.Generator, int, ScenarioConfig],
                            DeviceFleet]] = {
    "uniform": _uniform,
    "tiered-fleet": _tiered_fleet,
    "byzantine": _byzantine,
    "byzantine-colluding": _byzantine_colluding,
}


def make_fleet(cfg: ScenarioConfig, num_clients: int,
               device: torch.device | str = "cuda") -> DeviceFleet:
    """Sample the :class:`DeviceFleet` of ``cfg.preset`` from ``cfg.seed``
    and place it on ``device`` (the GPU unless the caller asks for the
    CPU; without a GPU the default raises)."""
    dev = resolve_device(device, "make_fleet")
    if cfg.preset not in PRESETS:
        raise KeyError(f"unknown scenario preset {cfg.preset!r}; available: "
                       f"{sorted(PRESETS)}")
    g = seeded_generator(cfg.seed, 0xF1EE7)
    return PRESETS[cfg.preset](g, num_clients, cfg).to(dev)


def completion_time(fleet: DeviceFleet, sel: torch.Tensor,
                    eps: torch.Tensor, base: float = COMPLETION_BASE,
                    jitter: float = COMPLETION_JITTER) -> torch.Tensor:
    """Per-selected-client completion time ``[S]``:
    ``base * slowdown * exp(jitter * eps)`` with standard-normal ``eps``."""
    return base * fleet.slowdown[sel] * torch.exp(jitter * eps)


def participation(fleet: DeviceFleet, sel: torch.Tensor, round_idx: int,
                  drop: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mask, contribution)`` for the selected clients ``sel``.

    ``drop`` is the round's ``[S]`` 0/1 upload losses.  ``mask`` is 1 for
    a client that is available and whose upload survived;
    ``contribution = mask / slowdown``.
    """
    duty = fleet.duty_cycle[sel]
    phase = fleet.phase[sel]
    pos = torch.remainder(round_idx + phase, fleet.period).to(torch.float32)
    avail = (pos < duty * fleet.period).to(torch.float32)
    mask = avail * (1.0 - drop)
    return mask, mask / fleet.slowdown[sel]
