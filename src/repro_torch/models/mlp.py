"""Small dense net on flattened SynthFEMNIST images.

Counterpart of ``repro.models.mlp`` with the same ``loss``/``accuracy``
contract as :mod:`repro_torch.models.cnn`; the CPU tests drive the
engine with it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.data.synthetic import IMAGE_SHAPE, NUM_CLASSES
from repro_torch.models.cnn import _accuracy, _nll, he_normal

Params = Dict[str, torch.Tensor]

_IN = IMAGE_SHAPE[0] * IMAGE_SHAPE[1]


def init_mlp_params(generator: torch.Generator, hidden: int = 64,
                    device: torch.device | str = "cuda") -> Params:
    params = {
        "w1": he_normal((_IN, hidden), _IN, generator),
        "b1": torch.zeros(hidden),
        "w2": he_normal((hidden, NUM_CLASSES), hidden, generator),
        "b2": torch.zeros(NUM_CLASSES),
    }
    return {k: v.to(device) for k, v in params.items()}


def mlp_apply(params: Params, images: torch.Tensor) -> torch.Tensor:
    """``images [B, 28, 28]`` (or flat) → logits ``[B, 62]``."""
    x = images.reshape(images.shape[0], -1)
    x = torch.relu(x @ params["w1"] + params["b1"])
    return x @ params["w2"] + params["b2"]


def mlp_loss(params: Params, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    return _nll(mlp_apply(params, images), labels)


def mlp_accuracy(params: Params, images: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _accuracy(mlp_apply(params, images), labels, mask)
