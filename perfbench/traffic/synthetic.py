"""Frozen copy of the port's synthetic federated data
(``src/repro_torch/data/synthetic.py``), numpy only: image classification
with a Dirichlet label skew, and token streams with a per-client Zipf
unigram and a planted bigram.

The benchmark draws its traffic from this copy, so a later change to the
program's data module cannot change what the benchmark feeds it.
``perfbench/tests/test_perfbench_counts.py`` holds the copy to the port's
module draw for draw.
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
    """Gaussian class prototypes plus noise, flat or as images, with a
    Dirichlet(alpha) label skew across clients."""
    num_clients: int = 100
    num_classes: int = 10
    feature_dim: int = 64
    image_shape: Tuple[int, ...] = ()
    alpha: float = 0.3
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        dim = (int(np.prod(self.image_shape)) if self.image_shape
               else self.feature_dim)
        self.prototypes = rng.normal(
            size=(self.num_classes, dim)).astype(np.float32)
        self.prototypes /= np.linalg.norm(self.prototypes, axis=1,
                                          keepdims=True)
        self.label_dist = dirichlet_label_partition(
            rng, self.num_classes, self.num_clients, self.alpha)

    def client_batch(self, client: int, step: int, batch_size: int) -> Dict:
        rng = np.random.default_rng(
            hash((self.seed, int(client), int(step))) % (2**63))
        y = rng.choice(self.num_classes, size=batch_size,
                       p=self.label_dist[client])
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
    """Token streams: each client draws from its own Zipf-reweighted
    unigram distribution, with a planted bigram next = (31·tok + 7) % V
    taken with probability 1/2."""
    num_clients: int = 16
    vocab_size: int = 256
    alpha: float = 0.5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        base = 1.0 / np.arange(1, self.vocab_size + 1) ** 1.1
        skew = rng.dirichlet([self.alpha] * self.vocab_size,
                             size=self.num_clients)
        dist = base[None, :] * (0.5 + skew * self.vocab_size * 0.5)
        self.unigram = dist / dist.sum(1, keepdims=True)
        self.mult, self.add = 31, 7
        self._cdf = {}

    def _choice(self, rng, client: int, size: int):
        """``rng.choice(vocab_size, size=size, p=unigram[client])``, the
        same draws, from the client's cumulative sum made once."""
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

    def mesh_batch(self, round_idx: int, local_steps: int, global_batch: int,
                   seq_len: int) -> Dict:
        """A round's global batch (K, GB, S), client c owning the rows
        c·GB/m .. (c+1)·GB/m - 1."""
        per = global_batch // self.num_clients
        rows = [self.client_batch(c, round_idx * local_steps + k, per,
                                  seq_len)
                for k in range(local_steps) for c in range(self.num_clients)]
        toks = np.stack([b["tokens"] for b in rows]).reshape(
            local_steps, self.num_clients * per, seq_len)
        labs = np.stack([b["labels"] for b in rows]).reshape(
            local_steps, self.num_clients * per, seq_len)
        return {"tokens": toks, "labels": labs}
