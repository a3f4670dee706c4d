"""Carry parameters and fleets between the reference's numpy arrays and
the port.

The port keeps the reference's parameter names and layouts (conv
weights HWIO, dense weights ``[in, out]``), so carrying a parameter set
across is a copy per leaf, with no transposes.  A device fleet carries
across field by field.  The tests use both to give the two packages the
same weights and the same fleet.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.federated.scenarios import DeviceFleet


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device: torch.device | str = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Reference parameters (as numpy arrays) → a port parameter dict on
    ``device``, copied."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in np_params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """A port parameter dict → numpy arrays in the same layouts."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def fleet_from_jax(arrays: Mapping[str, np.ndarray],
                   device: torch.device | str = "cuda",
                   **static: Any) -> DeviceFleet:
    """A reference fleet's arrays (``tier``, ``slowdown``,
    ``dropout_prob``, ``duty_cycle``, ``phase`` and optionally
    ``corrupt``, as numpy) and its static fields (``period``, ``attack``,
    ``attack_scale``) → a port :class:`DeviceFleet` on ``device``."""
    tensors = {k: torch.tensor(np.asarray(v), device=device)
               for k, v in arrays.items()}
    return DeviceFleet(**tensors, **static)
