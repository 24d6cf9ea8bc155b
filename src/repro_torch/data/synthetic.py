"""Synthetic federated classification data with Dirichlet non-IID skew.

A copy of ``repro.data.synthetic.FederatedClassification`` (numpy only):
Gaussian class prototypes plus noise, flat features or images, and a
Dirichlet(α) label skew across clients. The same seed draws the same
batches as the JAX package (tests/test_torch_imports.py), so the two can be
fed identical data. Batches are numpy arrays; the caller moves them to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def dirichlet_label_partition(rng: np.random.Generator, num_classes: int,
                              num_clients: int, alpha: float) -> np.ndarray:
    """(num_clients, num_classes) label distribution per client."""
    if np.isinf(alpha):
        return np.full((num_clients, num_classes), 1.0 / num_classes)
    return rng.dirichlet([alpha] * num_classes, size=num_clients)


@dataclass
class FederatedClassification:
    num_clients: int = 100
    num_classes: int = 10
    feature_dim: int = 64          # flat features; or image=(H,W,C) below
    image_shape: Tuple[int, ...] = ()   # e.g. (32,32,3) for ConvMixer
    alpha: float = 0.3             # Dirichlet non-IID concentration
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        dim = int(np.prod(self.image_shape)) if self.image_shape else self.feature_dim
        self.prototypes = rng.normal(size=(self.num_classes, dim)).astype(np.float32)
        self.prototypes /= np.linalg.norm(self.prototypes, axis=1, keepdims=True)
        self.label_dist = dirichlet_label_partition(
            rng, self.num_classes, self.num_clients, self.alpha)

    def client_batch(self, client: int, step: int, batch_size: int) -> Dict:
        rng = np.random.default_rng(
            hash((self.seed, int(client), int(step))) % (2**63))
        y = rng.choice(self.num_classes, size=batch_size, p=self.label_dist[client])
        x = self.prototypes[y] + self.noise * rng.normal(
            size=(batch_size, self.prototypes.shape[1])).astype(np.float32)
        x = x.astype(np.float32)
        if self.image_shape:
            x = x.reshape((batch_size,) + tuple(self.image_shape))
        return {"x": x, "y": y.astype(np.int32)}

    def round_batches(self, clients, round_idx: int, local_steps: int,
                      batch_size: int) -> Dict:
        """Stacked batches for the sampled clients: leaves (n, K, B, ...)."""
        out = [[self.client_batch(c, round_idx * local_steps + k, batch_size)
                for k in range(local_steps)] for c in clients]
        return {
            "x": np.stack([[b["x"] for b in row] for row in out]),
            "y": np.stack([[b["y"] for b in row] for row in out]),
        }
