"""SynthFEMNIST — an offline stand-in for LEAF's FEMNIST (paper §3).

The port's own copy of ``repro.data.synthetic`` (numpy only, so it does
not pull in the JAX package): the same seed gives byte-equal arrays,
which is what lets the port's tests feed both packages one dataset.

FEMNIST is not downloaded.  We generate a writer-partitioned, non-IID
28x28 / 62-class dataset whose *structure* matches what LEAF reports for
FEMNIST:

* 62 classes (10 digits + 52 letters),
* samples partitioned by writer, each writer owning a modest, skewed subset
  of classes (non-IID by construction),
* power-law writer dataset sizes (mean ≈ 226 in full FEMNIST; configurable),
* per-writer style variation (affine warp + stroke-thickness noise) so that
  local distributions genuinely differ — criteria like model divergence get
  realistic spread.

Class templates are procedurally generated glyph blobs (random strokes per
class, fixed by seed) so the task is learnable but non-trivial.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

NUM_CLASSES = 62
IMAGE_SHAPE = (28, 28)


@dataclass
class FederatedDataset:
    """Client-partitioned dataset with ragged local shards (dense padded).

    * ``images``: ``[num_clients, max_local, 28, 28]`` float32 in [0, 1]
    * ``labels``: ``[num_clients, max_local]`` int32
    * ``counts``: ``[num_clients]`` — true local sizes (rest is padding)
    * ``test_*``: same layout for the per-client local test sets
    """

    images: np.ndarray
    labels: np.ndarray
    counts: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    test_counts: np.ndarray

    @property
    def num_clients(self) -> int:
        return self.images.shape[0]

    def label_histogram(self, k: int) -> np.ndarray:
        h = np.zeros(NUM_CLASSES, np.int64)
        n = int(self.counts[k])
        np.add.at(h, self.labels[k, :n], 1)
        return h


def _class_templates(rng: np.random.Generator) -> np.ndarray:
    """[62, 28, 28] stroke-based glyph templates, one per class."""
    temps = np.zeros((NUM_CLASSES, *IMAGE_SHAPE), np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for c in range(NUM_CLASSES):
        n_strokes = rng.integers(2, 5)
        img = np.zeros(IMAGE_SHAPE, np.float32)
        for _ in range(n_strokes):
            # random quadratic bezier stroke
            pts = rng.uniform(4, 24, size=(3, 2)).astype(np.float32)
            ts = np.linspace(0, 1, 24, dtype=np.float32)[:, None]
            curve = ((1 - ts) ** 2 * pts[0] + 2 * ts * (1 - ts) * pts[1]
                     + ts**2 * pts[2])
            for cy, cx in curve:
                img += np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 2.5))
        temps[c] = np.clip(img / max(img.max(), 1e-6), 0, 1)
    return temps


def _writer_style(rng: np.random.Generator) -> Dict[str, float]:
    return {
        "angle": float(rng.uniform(-0.35, 0.35)),     # radians
        "scale": float(rng.uniform(0.85, 1.15)),
        "shift_y": float(rng.uniform(-2.0, 2.0)),
        "shift_x": float(rng.uniform(-2.0, 2.0)),
        "thickness": float(rng.uniform(0.7, 1.4)),
        "contrast": float(rng.uniform(0.8, 1.2)),
    }


def _render(template: np.ndarray, style: Dict[str, float],
            rng: np.random.Generator) -> np.ndarray:
    """Apply writer style + sample noise to a class template."""
    h, w = IMAGE_SHAPE
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ang, sc = style["angle"], style["scale"]
    cos_a, sin_a = np.cos(ang) / sc, np.sin(ang) / sc
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ys = cos_a * (yy - cy) - sin_a * (xx - cx) + cy - style["shift_y"]
    xs = sin_a * (yy - cy) + cos_a * (xx - cx) + cx - style["shift_x"]
    yi = np.clip(ys, 0, h - 1).astype(np.int32)
    xi = np.clip(xs, 0, w - 1).astype(np.int32)
    img = template[yi, xi]
    img = img ** (1.0 / style["thickness"])       # stroke thickness proxy
    img = np.clip(img * style["contrast"], 0, 1)
    img = img + rng.normal(0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def make_synth_femnist(
    num_clients: int = 371,
    mean_samples: int = 60,
    classes_per_writer: Tuple[int, int] = (8, 24),
    test_fraction: float = 0.25,
    seed: int = 0,
) -> FederatedDataset:
    """Generate SynthFEMNIST.

    Defaults mirror the paper's subsample (371 clients); ``mean_samples``
    is reduced from FEMNIST's ~226 to keep CPU experiments tractable —
    scale it up freely on real hardware.
    """
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng)

    # Power-law local sizes (LEAF FEMNIST sizes are heavy-tailed).
    raw = rng.pareto(2.5, num_clients) + 1.0
    sizes = np.maximum(8, (raw / raw.mean() * mean_samples)).astype(np.int64)
    test_sizes = np.maximum(2, (sizes * test_fraction).astype(np.int64))
    max_n, max_t = int(sizes.max()), int(test_sizes.max())

    images = np.zeros((num_clients, max_n, *IMAGE_SHAPE), np.float32)
    labels = np.zeros((num_clients, max_n), np.int32)
    t_images = np.zeros((num_clients, max_t, *IMAGE_SHAPE), np.float32)
    t_labels = np.zeros((num_clients, max_t), np.int32)

    for k in range(num_clients):
        style = _writer_style(rng)
        n_cls = int(rng.integers(*classes_per_writer))
        classes = rng.choice(NUM_CLASSES, size=n_cls, replace=False)
        # skewed class proportions within the writer
        props = rng.dirichlet(np.full(n_cls, 0.5))
        for split, (buf_i, buf_l, n) in {
            "train": (images, labels, int(sizes[k])),
            "test": (t_images, t_labels, int(test_sizes[k])),
        }.items():
            ls = rng.choice(classes, size=n, p=props)
            for j, c in enumerate(ls):
                buf_i[k, j] = _render(templates[c], style, rng)
                buf_l[k, j] = c

    return FederatedDataset(
        images=images, labels=labels, counts=sizes.astype(np.int32),
        test_images=t_images, test_labels=t_labels,
        test_counts=test_sizes.astype(np.int32),
    )
