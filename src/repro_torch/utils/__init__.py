"""Flat-vector helpers for ``dict[str, Tensor]`` parameter sets."""
