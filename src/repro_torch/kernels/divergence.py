"""K2 · the squared-divergence CUDA kernel and its wrapper.

``out[k] = sum_n (global_vec[n] - stacked[k, n])^2`` in f32: the
streamed ``||w_G - w_k||^2`` behind the Md criterion.  Replaces the
Pallas TPU kernel ``repro.kernels.divergence.divergence_sq``; the two
passes, the bound on an H100 and what the design does about it are
described in ``csrc/divergence.cu``.  :func:`divergence_ref` is its
plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import divergence_ref

__all__ = ["divergence_sq", "divergence_ref"]

_ENTRY = {torch.float32: "divergence_sq_f32",
          torch.bfloat16: "divergence_sq_bf16"}

# Columns each first-pass block sums per row: 4 chunks of 256 threads x 8.
# Sets only how many partials a row gets (the grid's second dimension,
# capped at CUDA's 65535); any count gives the same sums up to rounding.
_COLS_PER_PART = 4 * 2048
_MAX_PARTS = 65535


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("divergence"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def divergence_sq(stacked: torch.Tensor,
                  global_vec: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``[K, N]`` and ``[N]`` of one dtype (f32 or
    bf16) on one CUDA device → f32 ``[K]``.

    Raises on anything the kernel does not take, including tensors that
    are not on a CUDA device.  Counts each launch (both passes together)
    in ``divergence_sq.launches``.
    """
    if stacked.device.type != "cuda":
        raise ValueError(f"divergence_sq runs on CUDA tensors, got "
                         f"{stacked.device}")
    if stacked.dim() != 2 or stacked.shape[0] < 1 or stacked.shape[1] < 1:
        raise ValueError(f"stacked must be [K, N] with K, N >= 1, got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"stacked must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    K, N = stacked.shape
    if global_vec.shape != (N,) or global_vec.dtype != stacked.dtype:
        raise ValueError(f"global_vec must be {stacked.dtype} [{N}], got "
                         f"{global_vec.dtype} {tuple(global_vec.shape)}")
    if global_vec.device != stacked.device:
        raise ValueError(f"global_vec on {global_vec.device}, stacked on "
                         f"{stacked.device}")
    if not (stacked.is_contiguous() and global_vec.is_contiguous()):
        raise ValueError("divergence_sq needs contiguous inputs")
    parts = min(-(-N // _COLS_PER_PART), _MAX_PARTS)
    partial = torch.empty((K, parts), dtype=torch.float32,
                          device=stacked.device)
    out = torch.empty(K, dtype=torch.float32, device=stacked.device)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(stacked.dtype)(stacked.data_ptr(), global_vec.data_ptr(),
                                    partial.data_ptr(), out.data_ptr(), K, N,
                                    parts, stream)
    if err:
        raise RuntimeError(f"divergence_sq kernel launch failed: CUDA error "
                           f"{err}")
    divergence_sq.launches += 1
    return out


divergence_sq.launches = 0
