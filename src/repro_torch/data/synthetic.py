"""Synthetic federated datasets with Dirichlet non-IID client skew.

Copies of ``repro.data.synthetic`` (numpy only):

  * ``FederatedClassification`` — Gaussian class prototypes plus noise,
    flat features or images, and a Dirichlet(α) label skew across clients;
  * ``FederatedLMData`` — token streams where each client draws from its
    own Zipf-reweighted unigram distribution over the vocabulary, with a
    planted bigram structure.

The same seed draws the same batches as the JAX package
(tests/test_torch_imports.py, tests/test_torch_lm_train.py): the batch
seeds hash a tuple of ints, which Python does not salt. Batches are numpy
arrays; the caller moves them to its device.
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


@dataclass
class FederatedLMData:
    num_clients: int = 16
    vocab_size: int = 256
    alpha: float = 0.5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        base = 1.0 / np.arange(1, self.vocab_size + 1) ** 1.1  # zipf
        skew = rng.dirichlet([self.alpha] * self.vocab_size, size=self.num_clients)
        dist = base[None, :] * (0.5 + skew * self.vocab_size * 0.5)
        self.unigram = dist / dist.sum(1, keepdims=True)
        # planted deterministic bigram: next = (tok * 31 + 7) % V with prob 0.5
        self.mult, self.add = 31, 7
        self._cdf = {}

    def _choice(self, rng, client: int, size: int):
        """``rng.choice(vocab_size, size=size, p=unigram[client])``, the
        same draws: numpy's ``Generator.choice`` with ``p`` searches one
        uniform draw a sample in the row's normalized cumulative sum, here
        made once a client rather than once a call (at a vocabulary of
        256,000 the sum was ~4 ms a call, 513 calls a sequence)."""
        cdf = self._cdf.get(client)
        if cdf is None:
            cdf = self.unigram[client].cumsum()
            cdf /= cdf[-1]
            self._cdf[client] = cdf
        return cdf.searchsorted(rng.random(size), side="right")

    def client_batch(self, client: int, step: int, batch_size: int,
                     seq_len: int) -> Dict:
        rng = np.random.default_rng(
            hash((self.seed, int(client), int(step))) % (2**63))
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = self._choice(rng, client, batch_size)
        for t in range(seq_len):
            fresh = self._choice(rng, client, batch_size)
            follow = (toks[:, t] * self.mult + self.add) % self.vocab_size
            coin = rng.random(batch_size) < 0.5
            toks[:, t + 1] = np.where(coin, follow, fresh)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def round_batches(self, clients, round_idx: int, local_steps: int,
                      batch_size: int, seq_len: int) -> Dict:
        rows = [[self.client_batch(c, round_idx * local_steps + k, batch_size,
                                   seq_len) for k in range(local_steps)]
                for c in clients]
        return {
            "tokens": np.stack([[b["tokens"] for b in r] for r in rows]),
            "labels": np.stack([[b["labels"] for b in r] for r in rows]),
        }

    def mesh_batch(self, round_idx: int, local_steps: int, global_batch: int,
                   seq_len: int) -> Dict:
        """Batch for the mesh path: (K, GB, S) with client c owning the
        contiguous slice c·GB/m ... (c+1)·GB/m."""
        per = global_batch // self.num_clients
        rows = [self.client_batch(c, round_idx * local_steps + k, per, seq_len)
                for k in range(local_steps) for c in range(self.num_clients)]
        toks = np.stack([b["tokens"] for b in rows]).reshape(
            local_steps, self.num_clients * per, seq_len)
        labs = np.stack([b["labels"] for b in rows]).reshape(
            local_steps, self.num_clients * per, seq_len)
        return {"tokens": toks, "labels": labs}
