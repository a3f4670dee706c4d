"""Plain PyTorch versions of the server's two streaming reductions.

Counterparts of ``repro.kernels.ref.weighted_agg_ref`` and
``divergence_ref``: the arithmetic the CUDA kernels implement, written
as broadcast-and-sum.  ``kernels.ops`` runs them for tensors on the CPU,
and ``chip_smoke.py`` holds each kernel against them on the GPU.
"""
from __future__ import annotations

import torch


def weighted_agg_ref(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_k w[k] * x[k, n]`` accumulated in f32.

    ``stacked``: [K, N] (f32 or bf16); ``weights``: [K].  Returns the
    dtype of ``stacked``.
    """
    acc = (weights.to(torch.float32)[:, None]
           * stacked.to(torch.float32)).sum(dim=0)
    return acc.to(stacked.dtype)


def divergence_ref(stacked: torch.Tensor,
                   global_vec: torch.Tensor) -> torch.Tensor:
    """Per-client squared L2 distance to the global vector, f32 ``[K]``.

    ``stacked``: [K, N]; ``global_vec``: [N].
    """
    d = global_vec.to(torch.float32)[None, :] - stacked.to(torch.float32)
    return (d * d).sum(dim=1)
