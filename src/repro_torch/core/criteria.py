"""Client criteria (paper §3, "Identified local criteria") and registry.

Counterpart of ``repro.core.criteria`` for the paper's three criteria:

* ``dataset_size`` (Ds)     — |D_k| share (the FedAvg baseline criterion)
* ``label_diversity`` (Ld)  — number of distinct labels share
* ``model_divergence`` (Md) — phi_k / sum phi, phi = 1/sqrt(||w_G - w_k||_2 + 1)

The reference evaluates a criterion on one client and vmaps it; here a
criterion takes a :class:`ClientContext` whose fields carry a leading
client axis and returns one raw value per client, ``[S]``.  The server
then normalizes raw values over the round's participants
(:func:`normalize_criteria`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclass
class ClientContext:
    """What a criterion may inspect, batched over the round's clients.

    * ``num_examples``   ``[S]`` local dataset sizes |D_k|
    * ``label_counts``   ``[S, C]`` local label histograms
    * ``update_sq_norm`` ``[S]`` f32 ``||w_k - w_G||^2``, streamed by
      ``kernels.ops.flat_divergence_sq``; built only when a configured
      criterion declares ``needs=("update",)``
    """

    num_examples: Optional[torch.Tensor] = None
    label_counts: Optional[torch.Tensor] = None
    update_sq_norm: Optional[torch.Tensor] = None


def dataset_size(ctx: ClientContext) -> torch.Tensor:
    """Ds — raw |D_k|."""
    return ctx.num_examples.to(torch.float32)


def label_diversity(ctx: ClientContext) -> torch.Tensor:
    """Ld — number of distinct labels in the local dataset."""
    return (ctx.label_counts > 0).to(torch.float32).sum(dim=-1)


def model_divergence(ctx: ClientContext) -> torch.Tensor:
    """Md — phi_k = 1 / sqrt(||w_G - w_k||_2 + 1); rewards small divergence."""
    nrm = torch.sqrt(ctx.update_sq_norm.to(torch.float32))
    return 1.0 / torch.sqrt(nrm + 1.0)


CriterionFn = Callable[[ClientContext], torch.Tensor]

_REGISTRY: Dict[str, Tuple[CriterionFn, Tuple[str, ...]]] = {}


def register_criterion(name: str, fn: CriterionFn,
                       needs: Tuple[str, ...] = ()) -> None:
    """Register a criterion and the expensive context it needs.

    ``needs=("update",)`` asks the round engine for the streamed
    ``update_sq_norm``; it is computed only when some configured
    criterion declares it.
    """
    if name in _REGISTRY:
        raise ValueError(f"criterion {name!r} already registered")
    _REGISTRY[name] = (fn, tuple(needs))


for _name, _fn, _needs in [
    ("dataset_size", dataset_size, ()),
    ("label_diversity", label_diversity, ()),
    ("model_divergence", model_divergence, ("update",)),
]:
    register_criterion(_name, _fn, needs=_needs)

# Short aliases used throughout the paper's tables.
ALIASES = {"Ds": "dataset_size", "Ld": "label_diversity",
           "Md": "model_divergence"}


def resolve(name: str) -> str:
    return ALIASES.get(name, name)


def _lookup(name: str) -> Tuple[CriterionFn, Tuple[str, ...]]:
    canon = resolve(name)
    if canon not in _REGISTRY:
        raise KeyError(f"unknown criterion {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[canon]


def get_criterion(name: str) -> CriterionFn:
    return _lookup(name)[0]


def criterion_needs(name: str) -> Tuple[str, ...]:
    return _lookup(name)[1]


def measure_criteria(names: Tuple[str, ...],
                     ctx: ClientContext) -> torch.Tensor:
    """Raw criteria ``[S, m]`` for a batched context, one column per name."""
    return torch.stack([get_criterion(n)(ctx).to(torch.float32)
                        for n in names], dim=1)


def normalize_criteria(raw: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       eps: float = 1e-12) -> torch.Tensor:
    """Normalize raw values so ``sum_k c^k = 1`` over participants.

    ``raw`` is ``[K]`` or ``[K, m]`` (normalized per column); ``mask`` an
    optional ``[K]`` 0/1 participation mask — non-participants get 0,
    and an all-zero column falls back to uniform over participants.
    """
    raw = raw.to(torch.float32)
    squeeze = raw.dim() == 1
    if squeeze:
        raw = raw.unsqueeze(1)
    if mask is None:
        mask = torch.ones(raw.shape[0], device=raw.device)
    mask = mask.to(torch.float32)
    masked = raw * mask[:, None]
    z = masked.sum(dim=0, keepdim=True)
    uniform = mask[:, None] / torch.clamp(mask.sum(), min=1.0)
    out = torch.where(z > eps, masked / torch.clamp(z, min=eps), uniform)
    return out[:, 0] if squeeze else out
