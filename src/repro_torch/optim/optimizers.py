"""Plain SGD, the paper's local optimizer.

Counterpart of ``repro.optim.optimizers.sgd`` without momentum or weight
decay (the paper uses neither): ``p ← p + (−lr · g)``, the reference's
update and apply written as one step.  Works leafwise on a parameter
dict, stacked over clients or not.
"""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def sgd(lr: float):
    """Return ``step(params, grads) -> params``, a new dict each call."""

    def step(params: Params, grads: Params) -> Params:
        return {k: p + (-lr) * grads[k] for k, p in params.items()}

    return step
