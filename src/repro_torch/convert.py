"""Carry parameters between the reference's numpy arrays and the port.

The port keeps the reference's parameter names and layouts (conv
weights HWIO, dense weights ``[in, out]``), so carrying a parameter set
across is a copy per leaf, with no transposes.  The tests use it to give
both packages the same weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
