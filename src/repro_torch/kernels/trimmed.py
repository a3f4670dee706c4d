"""K4 · the trimmed-mean CUDA kernel and its wrapper.

Per column of the round's flat ``[S, N]`` client matrix, the weighted
mean of the values left after dropping the ``trim`` largest and ``trim``
smallest: the commit of ``TrimmedMeanStrategy``.  Replaces the Pallas
TPU kernel ``repro.kernels.trimmed.trimmed_agg``; the kernel, its bound
on an H100 and what its design does about it are described in
``csrc/trimmed.cu``.  :func:`trimmed_agg_ref` is its plain PyTorch
version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import trimmed_agg_ref

__all__ = ["trimmed_agg", "trimmed_agg_ref", "max_rows"]

_ENTRY = {torch.float32: "trimmed_agg_f32",
          torch.bfloat16: "trimmed_agg_bf16"}


@functools.lru_cache(maxsize=None)
def max_rows() -> int:
    """The largest ``S`` whose tile fits a block of 32 columns in the
    card's shared memory (1,708 on an H100).  The kernel's source owns
    the block's layout, so this asks it."""
    fn = _build.load("trimmed").trimmed_agg_max_rows
    fn.argtypes, fn.restype = [], ctypes.c_int64
    return int(fn())


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("trimmed"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trimmed_agg(stacked: torch.Tensor, weights: torch.Tensor,
                trim: int) -> torch.Tensor:
    """Launch the kernel: ``[S, N]`` f32/bf16 and ``[S]`` f32 on one CUDA
    device, ``0 <= 2*trim < S`` → ``[N]`` of ``stacked``'s dtype.

    Raises on anything the kernel does not take, including tensors that
    are not on a CUDA device and an ``S`` whose tile does not fit in
    shared memory (above :func:`max_rows`).  Counts each launch in
    ``trimmed_agg.launches``.
    """
    if stacked.device.type != "cuda":
        raise ValueError(f"trimmed_agg runs on CUDA tensors, got "
                         f"{stacked.device}")
    if stacked.dim() != 2 or stacked.shape[0] < 1 or stacked.shape[1] < 1:
        raise ValueError(f"stacked must be [S, N] with S, N >= 1, got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"stacked must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    S, N = stacked.shape
    if not 0 <= 2 * trim < S:
        raise ValueError(f"need 0 <= 2*trim < S, got trim={trim} S={S}")
    if weights.shape != (S,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be float32 [{S}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, stacked on "
                         f"{stacked.device}")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("trimmed_agg needs contiguous inputs")
    with torch.cuda.device(stacked.device):
        if S > max_rows():
            raise ValueError(f"trimmed_agg takes at most S={max_rows()} rows "
                             f"(its [S, 32] tile must fit in a block's "
                             f"shared memory), got S={S}")
        out = torch.empty(N, dtype=stacked.dtype, device=stacked.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(stacked.dtype)(stacked.data_ptr(), weights.data_ptr(),
                                    out.data_ptr(), S, N, int(trim), stream)
    if err:
        raise RuntimeError(f"trimmed_agg kernel launch failed: CUDA error "
                           f"{err}")
    trimmed_agg.launches += 1
    return out


trimmed_agg.launches = 0
