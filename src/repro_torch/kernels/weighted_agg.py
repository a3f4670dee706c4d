"""K1 · the weighted-aggregation CUDA kernel and its wrapper.

``out[n] = sum_k weights[k] * stacked[k, n]`` over the round's flat
``[K, N]`` client matrix: the server's commit.  Replaces the Pallas TPU
kernel ``repro.kernels.weighted_agg.weighted_agg``; the kernel, its bound
on an H100 and what its design does about it are described in
``csrc/weighted_agg.cu``.  :func:`weighted_agg_ref` is its plain PyTorch
version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import weighted_agg_ref

__all__ = ["weighted_agg", "weighted_agg_ref"]

_ENTRY = {torch.float32: "weighted_agg_f32",
          torch.bfloat16: "weighted_agg_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("weighted_agg"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def weighted_agg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``[K, N]`` f32/bf16 and ``[K]`` f32 on one CUDA
    device → ``[N]`` of ``stacked``'s dtype, accumulated in f32.

    Raises on anything the kernel does not take, including tensors that
    are not on a CUDA device.  Counts each launch in
    ``weighted_agg.launches``.
    """
    if stacked.device.type != "cuda":
        raise ValueError(f"weighted_agg runs on CUDA tensors, got "
                         f"{stacked.device}")
    if stacked.dim() != 2 or stacked.shape[0] < 1 or stacked.shape[1] < 1:
        raise ValueError(f"stacked must be [K, N] with K, N >= 1, got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"stacked must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    K, N = stacked.shape
    if weights.shape != (K,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be float32 [{K}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, stacked on "
                         f"{stacked.device}")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("weighted_agg needs contiguous inputs")
    out = torch.empty(N, dtype=stacked.dtype, device=stacked.device)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(stacked.dtype)(stacked.data_ptr(), weights.data_ptr(),
                                    out.data_ptr(), K, N, stream)
    if err:
        raise RuntimeError(f"weighted_agg kernel launch failed: CUDA error "
                           f"{err}")
    weighted_agg.launches += 1
    return out


weighted_agg.launches = 0
