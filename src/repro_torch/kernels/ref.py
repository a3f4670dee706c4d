"""Plain PyTorch versions of the server's reductions.

Counterparts of ``repro.kernels.ref``'s ``weighted_agg_ref``,
``divergence_ref``, ``trimmed_agg_ref`` and ``krum_agg_ref``: the
arithmetic the CUDA kernels implement, written plainly.  ``kernels.ops``
runs them for tensors on the CPU, and ``chip_smoke.py`` holds each
kernel against them on the GPU.
"""
from __future__ import annotations

from typing import Tuple

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


def trimmed_agg_ref(stacked: torch.Tensor, weights: torch.Tensor,
                    trim: int) -> torch.Tensor:
    """Coordinate-wise weighted trimmed mean, accumulated in f32.

    ``stacked``: [K, N] (f32 or bf16); ``weights``: [K] f32; ``trim``:
    values removed per side per coordinate (``0 <= 2*trim < K``).  Per
    coordinate the ``trim`` smallest and ``trim`` largest values are
    dropped in stable ascending order (among duplicates the lowest client
    indices go at the bottom, the highest at the top, as ``jnp.argsort``
    orders them), and the survivors are combined by their normalized
    weights; if the surviving weight is ``<= 1e-12`` the unweighted mean
    of the survivors is used.  Returns the dtype of ``stacked``.
    """
    K = stacked.shape[0]
    if not 0 <= 2 * trim < K:
        raise ValueError(f"need 0 <= 2*trim < K, got trim={trim} K={K}")
    x = stacked.to(torch.float32)
    xs, order = torch.sort(x, dim=0, stable=True)
    ws = weights.to(torch.float32)[order]
    keep = torch.zeros((K, 1), dtype=torch.float32, device=x.device)
    keep[trim:K - trim] = 1.0
    num = (xs * ws * keep).sum(dim=0)
    den = (ws * keep).sum(dim=0)
    fallback = (xs * keep).sum(dim=0) / float(K - 2 * trim)
    out = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12),
                      fallback)
    return out.to(stacked.dtype)


def krum_agg_ref(stacked: torch.Tensor, weights: torch.Tensor, f: int,
                 m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-Krum from explicit pairwise differences (no Gram identity).

    ``stacked``: [S, N]; ``weights``: [S] f32; ``f``: assumed Byzantine
    bound (``f <= S - 3``); ``m``: selection size (``m = 1`` is Krum).
    Client ``i`` scores the summed squared distances to its ``S - f - 2``
    nearest other clients; zero-weight rows score ``+inf``.  The ``m``
    lowest scores (ties to the lower index) are averaged by their
    renormalized weights, or give the zero vector when they carry no
    weight.  Returns ``(aggregate [N] in stacked's dtype, scores [S])``.
    """
    S = stacked.shape[0]
    if not (f >= 0 and S - f - 2 >= 1):
        raise ValueError(f"need 0 <= f <= S-3 for S={S}, got f={f}")
    if not 1 <= m <= S:
        raise ValueError(f"need 1 <= m <= S={S}, got m={m}")
    x = stacked.to(torch.float32)
    diff = x[:, None, :] - x[None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    eye = torch.eye(S, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, torch.inf, d2)
    nn = torch.sort(d2, dim=1).values[:, :S - f - 2]
    w = weights.to(torch.float32)
    scores = torch.where(w > 0, nn.sum(dim=1), torch.inf)
    idx = torch.sort(scores, stable=True).indices[:m]
    sel = torch.zeros(S, dtype=torch.float32, device=x.device)
    sel[idx] = 1.0
    wk = w * sel
    den = wk.sum()
    num = wk @ x
    out = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12),
                      torch.zeros_like(num))
    return out.to(stacked.dtype), scores
