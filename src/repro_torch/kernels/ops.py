"""The server's flat-path reductions, dispatched by the tensor's device.

Counterpart of ``repro.kernels.ops.flat_weighted_agg`` and
``flat_divergence_sq``.  The choice follows the device of the tensor
given, never what the host has: a CPU tensor takes the plain PyTorch
version, a CUDA tensor the hand-written kernel, which raises rather than
fall back when it cannot run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.divergence import divergence_sq
from repro_torch.kernels.weighted_agg import weighted_agg


def flat_weighted_agg(stacked: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """``w_G[n] = sum_k p_k stacked[k, n]`` over the round's ``[S, N]``
    flat client matrix (f32 accumulation, ``stacked``'s dtype out)."""
    if stacked.device.type == "cpu":
        return ref.weighted_agg_ref(stacked, weights)
    return weighted_agg(stacked, weights)


def flat_divergence_sq(stacked: torch.Tensor,
                       global_vec: torch.Tensor) -> torch.Tensor:
    """Per-client squared L2 distance ``[S]`` (f32) to ``global_vec``,
    the Md criterion's input."""
    if stacked.device.type == "cpu":
        return ref.divergence_ref(stacked, global_vec)
    return divergence_sq(stacked, global_vec)
