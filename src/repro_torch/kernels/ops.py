"""The server's flat-path reductions, dispatched by the tensor's device.

Counterpart of ``repro.kernels.ops``'s ``flat_weighted_agg``,
``flat_divergence_sq``, ``flat_trimmed_agg`` and ``flat_krum_agg``.  The
choice follows the device of the tensor given, never what the host has:
a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel, which raises rather than fall back when it cannot
run.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import krum, ref
from repro_torch.kernels.divergence import divergence_sq
from repro_torch.kernels.trimmed import trimmed_agg
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


def flat_trimmed_agg(stacked: torch.Tensor, weights: torch.Tensor,
                     trim: int) -> torch.Tensor:
    """Coordinate-wise weighted trimmed mean ``[N]``: per column drop the
    ``trim`` largest and smallest client values (stable-sort tie rule)
    and take the weighted mean of the rest."""
    if stacked.device.type == "cpu":
        return ref.trimmed_agg_ref(stacked, weights, trim)
    return trimmed_agg(stacked, weights, trim)


def flat_krum_agg(stacked: torch.Tensor, weights: torch.Tensor, f: int,
                  m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-Krum aggregate ``([N], scores [S])``.

    On the CPU the distances come from the Gram identity over one
    ``x @ x.T`` in f32, as in the reference's plain path; the scoring and
    selection are shared with the kernel path.  A starved selection gives
    the zero vector: the caller owes the alive guard.
    """
    if stacked.device.type != "cpu":
        return krum.krum_agg(stacked, weights, f, m)
    x = stacked.to(torch.float32)
    d2 = krum.gram_sq_dists(x @ x.T)
    scores = krum.krum_scores(d2, weights, f)
    wsel, _ = krum.krum_select(scores, weights, m)
    return ref.weighted_agg_ref(stacked, wsel), scores
