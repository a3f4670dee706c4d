"""Flat-vector view of a ``dict[str, Tensor]`` parameter set.

Counterpart of ``repro.utils.pytree.FlatSpec``.  The reference ravels a
pytree in ``jax.tree.leaves`` order, which for a dict is sorted-key
order, and each leaf in its own (row-major) layout.  The port's models
keep the reference's parameter names and layouts, so a port flat vector
lines up with the reference's index for index.
"""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


class FlatSpec:
    """Ravel/unravel plan for one parameter-dict structure.

    The server keeps the global model as one ``[N]`` f32 vector and a
    round's client models as one ``[S, N]`` matrix, so the criteria and
    the commit are single streaming passes over it.
    """

    def __init__(self, template: Params):
        if not template:
            raise ValueError("FlatSpec needs at least one parameter")
        self.keys = tuple(sorted(template))
        self.shapes = tuple(tuple(template[k].shape) for k in self.keys)
        self.dtypes = tuple(template[k].dtype for k in self.keys)
        self.sizes = tuple(template[k].numel() for k in self.keys)
        self.num_params = sum(self.sizes)

    def ravel(self, params: Params) -> torch.Tensor:
        """Parameter dict → one ``[N]`` f32 vector (sorted-key order)."""
        return torch.cat([params[k].to(torch.float32).reshape(-1)
                          for k in self.keys])

    def stack_ravel(self, stacked: Params) -> torch.Tensor:
        """Stacked dict (leaves ``[S, ...]``) → one ``[S, N]`` f32 matrix.

        Row ``s`` equals ``ravel`` of client ``s``'s parameters.
        """
        s = stacked[self.keys[0]].shape[0]
        return torch.cat([stacked[k].to(torch.float32).reshape(s, -1)
                          for k in self.keys], dim=1)

    def unravel(self, vec: torch.Tensor) -> Params:
        """``[N]`` vector → dict with the template's shapes and dtypes.

        The leaves are views of ``vec`` where no cast is needed.
        """
        if vec.shape != (self.num_params,):
            raise ValueError(
                f"expected a [{self.num_params}] vector, got {tuple(vec.shape)}")
        parts = torch.split(vec, self.sizes)
        return {k: p.reshape(shape).to(dtype)
                for k, p, shape, dtype in zip(self.keys, parts, self.shapes,
                                              self.dtypes)}
