"""The paper's FEMNIST CNN (§3 "Convolutional model").

Counterpart of ``repro.models.cnn``: two 5x5 conv layers (32, 64
channels, SAME padding), each followed by 2x2 max pooling; FC-2048 with
ReLU; 62 logits.  6,603,710 parameters at ``hidden=2048``.

Parameters keep the reference's names and layouts — conv weights HWIO,
``fc_w`` ``[3136, hidden]``, inputs ``[B, 28, 28]`` — so a flat vector
of this model lines up with the reference's index for index.  The
forward permutes to NCHW/OIHW for ``F.conv2d`` and flattens back in
NHWC order before ``fc_w``: an NCHW flatten would silently permute
``fc_w``'s rows against the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.data.synthetic import IMAGE_SHAPE, NUM_CLASSES

Params = Dict[str, torch.Tensor]


def he_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal He init, as ``jax.nn.initializers.he_normal``.

    Variance ``2 / fan_in`` after truncation at two standard deviations
    (the 0.8796 factor undoes the truncation's shrinkage).  Drawn on the
    CPU from ``generator``; the draws are not JAX's.
    """
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    out = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def init_cnn_params(generator: torch.Generator, num_classes: int = NUM_CLASSES,
                    hidden: int = 2048,
                    device: torch.device | str = "cuda") -> Params:
    flat = (IMAGE_SHAPE[0] // 4) * (IMAGE_SHAPE[1] // 4) * 64  # 7*7*64
    params = {
        "conv1_w": he_normal((5, 5, 1, 32), 5 * 5 * 1, generator),
        "conv1_b": torch.zeros(32),
        "conv2_w": he_normal((5, 5, 32, 64), 5 * 5 * 32, generator),
        "conv2_b": torch.zeros(64),
        "fc_w": he_normal((flat, hidden), flat, generator),
        "fc_b": torch.zeros(hidden),
        "out_w": he_normal((hidden, num_classes), hidden, generator),
        "out_b": torch.zeros(num_classes),
    }
    return {k: v.to(device) for k, v in params.items()}


def cnn_apply(params: Params, images: torch.Tensor) -> torch.Tensor:
    """``images [B, 28, 28]`` (or ``[B, 28, 28, 1]``) → logits ``[B, 62]``."""
    x = images if images.dim() == 4 else images.unsqueeze(-1)   # NHWC
    x = x.permute(0, 3, 1, 2)                                   # NCHW
    for i in (1, 2):
        w = params[f"conv{i}_w"].permute(3, 2, 0, 1)            # HWIO→OIHW
        x = F.conv2d(x, w, params[f"conv{i}_b"], padding=2)     # SAME, 5x5
        x = F.max_pool2d(F.relu(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)           # NHWC flatten
    x = F.relu(x @ params["fc_w"] + params["fc_b"])
    return x @ params["out_w"] + params["out_b"]


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long().unsqueeze(1)).mean()


def _accuracy(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    correct = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    if mask is None:
        return correct.mean()
    m = mask.to(torch.float32)
    return (correct * m).sum() / torch.clamp(m.sum(), min=1.0)


def cnn_loss(params: Params, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    return _nll(cnn_apply(params, images), labels)


def cnn_accuracy(params: Params, images: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _accuracy(cnn_apply(params, images), labels, mask)
