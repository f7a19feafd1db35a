"""Class-conditional synthetic pest images (NHWC, float32 in [0, 1]).

The port's own counterpart of ``repro.data.synthetic.SyntheticPestImages``:
the same recipe (per-class oriented sinusoidal texture + class blob + class
colour + pixel noise, 12 classes like the Kaggle Agricultural Pests set),
drawn from numpy generators seeded by ``seed``. The reference draws its
images from threefry, so the two packages' synthetic images differ; parity
runs hand both the same arrays through ``DataSpec(kind="arrays")``.

``synthetic_tokens`` is the token stream of the transformer family, with the
reference's law (``repro/data/synthetic.py:75``): Zipf-like ranks, and with
probability 0.5 a copy of the token ``copy_period`` positions back. It too
draws from a numpy generator, not threefry; parity runs pass the
reference's arrays through ``compile_experiment(data=...)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PEST_CLASSES = ["ants", "bees", "beetles", "caterpillars", "moths",
                "earthworms", "earwigs", "grasshoppers", "slugs", "snails",
                "wasps", "weevils"]


@dataclasses.dataclass
class SyntheticPestImages:
    """Deterministic class-conditional image generator (NHWC, float32)."""

    num_classes: int = 12
    image_size: int = 64
    channels: int = 3
    seed: int = 0

    def _class_params(self):
        rng = np.random.RandomState(self.seed)
        freqs = rng.uniform(2.0, 8.0, size=(self.num_classes,))
        thetas = rng.uniform(0, np.pi, size=(self.num_classes,))
        colors = rng.uniform(0.2, 0.9, size=(self.num_classes, self.channels))
        blob_xy = rng.uniform(0.2, 0.8, size=(self.num_classes, 2))
        return freqs, thetas, colors, blob_xy

    def sample(self, rng: np.random.Generator, n: int):
        """Returns (images (n, H, W, C) float32, labels (n,) int32)."""
        freqs, thetas, colors, blob_xy = self._class_params()
        labels = rng.integers(0, self.num_classes, size=n).astype(np.int32)
        h = w = self.image_size
        yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                             np.linspace(0, 1, w, dtype=np.float32),
                             indexing="ij")
        th = (thetas[labels] + 0.1 * rng.standard_normal(n)).astype(np.float32)
        u = (xx[None] * np.cos(th)[:, None, None]
             + yy[None] * np.sin(th)[:, None, None])
        f = freqs[labels].astype(np.float32)[:, None, None]
        tex = 0.5 + 0.5 * np.sin(2 * np.pi * f * u)
        cx = blob_xy[labels, 0].astype(np.float32)[:, None, None]
        cy = blob_xy[labels, 1].astype(np.float32)[:, None, None]
        blob = np.exp(-(((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2) / 0.02))
        base = 0.6 * tex + 0.4 * blob
        img = base[..., None] * colors[labels].astype(np.float32)[:, None, None, :]
        img += 0.15 * rng.standard_normal(img.shape, dtype=np.float32)
        return np.clip(img, 0.0, 1.0).astype(np.float32), labels


def synthetic_tokens(rng: np.random.Generator, batch: int, seq_len: int,
                     vocab: int, *, copy_period: int = 16) -> np.ndarray:
    """(batch, seq_len) int32 tokens: ranks floor(u^-0.9 - 1) mod vocab with
    u ~ U[1e-6, 1), and tokens[t] = ranks[t - copy_period] (cyclically) with
    probability 0.5, so a small model gets below ln(vocab) quickly."""
    u = rng.uniform(1e-6, 1.0, size=(batch, seq_len))
    ranks = np.floor(u ** -0.9 - 1.0).astype(np.int64) % vocab
    copy_mask = rng.random((batch, seq_len)) < 0.5
    rolled = np.roll(ranks, copy_period, axis=1)
    return np.where(copy_mask, rolled, ranks).astype(np.int32)
