"""K5 · the pairwise-distance CUDA kernel, and Krum's scoring around it.

Krum and multi-Krum need every pairwise squared distance
``d2[i, j] = ||x_i - x_j||^2`` of the round's flat ``[S, N]`` client
matrix.  :func:`pairwise_sq_dists` launches the CUDA kernel that
accumulates the Gram matrix ``X X^T`` in one streaming pass and recovers
the distances from ``G[i, i] + G[j, j] - 2 G[i, j]``; it replaces the
Pallas TPU kernel ``repro.kernels.krum.pairwise_sq_dists``, and
``csrc/krum.cu`` describes the kernel, its bound on an H100 and its
design.  Its plain PyTorch version is ``gram_sq_dists(x @ x.T)`` in f32.

Scoring and selection work on the ``[S, S]`` matrix and stay in torch,
as they stay in jnp in the reference (``repro.kernels.krum``):
:func:`krum_scores`, :func:`krum_select` and :func:`krum_agg`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.weighted_agg import weighted_agg

__all__ = ["pairwise_sq_dists", "gram_sq_dists", "krum_scores",
           "krum_select", "krum_agg"]

_ENTRY = {torch.float32: "pairwise_sq_dists_f32",
          torch.bfloat16: "pairwise_sq_dists_bf16"}
# Columns per shared-memory sub-tile (kDepth in csrc/krum.cu), the most
# chunks the N axis is cut into, and the most f32 partial sums kept.
# The chunking depends on S and N alone, so a result repeats bit for bit
# on any card.
_DEPTH = 32
_MAX_PARTS = 1024
_PARTIAL_CAP = 1 << 24


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("krum"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _chunking(S: int, N: int) -> Tuple[int, int]:
    """``(chunk, parts)``: every chunk a whole number of sub-tiles and
    none empty."""
    tiles = -(-N // _DEPTH)
    parts = min(_MAX_PARTS, tiles, max(1, _PARTIAL_CAP // (S * S)))
    chunk = -(-tiles // parts) * _DEPTH
    return chunk, -(-N // chunk)


def pairwise_sq_dists(stacked: torch.Tensor, with_gram: bool = False
                      ) -> Union[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the kernel: ``[S, N]`` f32/bf16 on one CUDA device → f32
    ``[S, S]`` squared distances (zero diagonal), and with ``with_gram``
    also the f32 Gram matrix ``X X^T`` they were computed from.

    Raises on anything the kernel does not take, including tensors that
    are not on a CUDA device.  Counts each launch (both passes together)
    in ``pairwise_sq_dists.launches``.
    """
    if stacked.device.type != "cuda":
        raise ValueError(f"pairwise_sq_dists runs on CUDA tensors, got "
                         f"{stacked.device}")
    if stacked.dim() != 2 or stacked.shape[0] < 1 or stacked.shape[1] < 1:
        raise ValueError(f"stacked must be [S, N] with S, N >= 1, got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"stacked must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    if not stacked.is_contiguous():
        raise ValueError("pairwise_sq_dists needs a contiguous input")
    S, N = stacked.shape
    chunk, parts = _chunking(S, N)
    dev = stacked.device
    partial = torch.empty((parts, S, S), dtype=torch.float32, device=dev)
    gram = torch.empty((S, S), dtype=torch.float32, device=dev)
    d2 = torch.empty((S, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(stacked.dtype)(stacked.data_ptr(), partial.data_ptr(),
                                    gram.data_ptr(), d2.data_ptr(), S, N,
                                    chunk, parts, stream)
    if err:
        raise RuntimeError(f"pairwise_sq_dists kernel launch failed: CUDA "
                           f"error {err}")
    pairwise_sq_dists.launches += 1
    return (d2, gram) if with_gram else d2


pairwise_sq_dists.launches = 0


def gram_sq_dists(gram: torch.Tensor) -> torch.Tensor:
    """Squared distances from an ``[S, S]`` f32 Gram matrix, floored at 0,
    with a zero diagonal."""
    S = gram.shape[0]
    sq = torch.diagonal(gram)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    return d2 * (1.0 - torch.eye(S, dtype=torch.float32, device=gram.device))


def krum_scores(d2: torch.Tensor, weights: torch.Tensor,
                f: int) -> torch.Tensor:
    """Krum score per client: the sum of its ``S - f - 2`` smallest
    squared distances to other clients; ``+inf`` for zero-weight rows, so
    a dropped upload is never selected.  Lower is better."""
    S = d2.shape[0]
    k_nn = S - f - 2
    if not (f >= 0 and k_nn >= 1):
        raise ValueError(f"need 0 <= f <= S-3 for S={S}, got f={f}")
    eye = torch.eye(S, dtype=torch.bool, device=d2.device)
    nn = torch.sort(torch.where(eye, torch.inf, d2), dim=1).values[:, :k_nn]
    return torch.where(weights.to(torch.float32) > 0, nn.sum(dim=1),
                       torch.inf)


def krum_select(scores: torch.Tensor, weights: torch.Tensor,
                m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(wsel, sel)``: the renormalized weights of the ``m`` lowest-score
    clients, and the 0/1 selection mask.

    A stable ascending sort picks them, so ties go to the lower client
    index, as ``lax.top_k`` breaks them in the reference (``torch.topk``
    makes no such promise).  When the selected rows carry no weight the
    weights are all zero, and an aggregate built from them is the zero
    vector: the caller must keep its previous model for such a starved
    round (the strategies' alive guard does).
    """
    S = scores.shape[0]
    if not 1 <= m <= S:
        raise ValueError(f"need 1 <= m <= S={S}, got m={m}")
    idx = torch.sort(scores, stable=True).indices[:m]
    sel = torch.zeros(S, dtype=torch.float32, device=scores.device)
    sel[idx] = 1.0
    wk = weights.to(torch.float32) * sel
    den = wk.sum()
    wsel = torch.where(den > 1e-12, wk / torch.clamp(den, min=1e-12),
                       torch.zeros_like(wk))
    return wsel, sel


def krum_agg(stacked: torch.Tensor, weights: torch.Tensor, f: int,
             m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-Krum on the card: ``(aggregate [N] in stacked's dtype,
    scores [S])`` over a CUDA ``[S, N]`` matrix.

    The distances come from the K5 kernel and the average of the ``m``
    selected rows from the K1 ``weighted_agg`` kernel (the same function
    as the reference's ``wsel @ stacked``).  ``m = 1`` is Krum.
    """
    d2 = pairwise_sq_dists(stacked)
    scores = krum_scores(d2, weights, f)
    wsel, _ = krum_select(scores, weights, m)
    return weighted_agg(stacked, wsel), scores
