"""The one generator of federated traffic: it reads a traffic mix
(``perfbench/traffic/<name>.json``) and draws its rounds from a seed.

A mix names its data (``data``: the kind and its parameters), the
federated job's settings (``fed``: ``FedConfig``'s fields, among them the
client count m, the cohort n and the local steps K), the per-step batch
(and, for token streams, the sequence length), and how many distinct
rounds the run pre-draws (``pool_rounds``). A simulated round
(:func:`federated_rounds`) is ``(ids, batches)``: n distinct client ids of
m, drawn without replacement, and each client's K batches as host numpy
arrays with leading (n, K). A mesh round (:func:`mesh_rounds`) is the
round's global batch, leading (K, batch). The same seed draws the same
rounds; every seed draws rounds of the same sizes.
"""
from __future__ import annotations

import numpy as np

from perfbench.traffic.synthetic import (FederatedClassification,
                                        FederatedLMData)


def _dataset(data: dict, num_clients: int, seed: int):
    kind = data["kind"]
    if kind == "classification":
        return FederatedClassification(
            num_clients=num_clients, num_classes=data["num_classes"],
            image_shape=tuple(data["image_shape"]), alpha=data["alpha"],
            noise=data["noise"], seed=seed)
    if kind == "tokens":
        return FederatedLMData(num_clients=num_clients,
                               vocab_size=data["vocab_size"],
                               alpha=data["alpha"], seed=seed)
    raise ValueError(f"unknown traffic data kind {kind!r}")


def federated_rounds(traffic: dict, seed: int, count: int) -> list:
    """``count`` rounds of ``traffic`` drawn from ``seed``: a list of
    ``(ids, batches)``; round r's batches are the clients' steps
    r·K .. r·K + K - 1."""
    fed = traffic["fed"]
    m, n, k = fed["num_clients"], fed["participating"], fed["local_steps"]
    data = _dataset(traffic["data"], m, seed)
    # the cohorts come from a stream of their own, apart from the data's
    rng = np.random.default_rng([seed, 1])
    rounds = []
    for r in range(count):
        ids = rng.choice(m, size=n, replace=False).astype(np.int64)
        rounds.append((ids, data.round_batches(ids, r, k, traffic["batch"])))
    return rounds


def mesh_rounds(traffic: dict, seed: int, count: int,
                num_clients: int) -> list:
    """``count`` mesh rounds of a token-stream ``traffic`` drawn from
    ``seed`` for the mesh's ``num_clients`` clients: each round's global
    batch, ``tokens`` and ``labels`` of (K, batch, seq_len)."""
    fed = traffic["fed"]
    data = _dataset(traffic["data"], num_clients, seed)
    return [data.mesh_batch(r, fed["local_steps"], traffic["batch"],
                            traffic["seq_len"]) for r in range(count)]
