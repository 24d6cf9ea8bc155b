"""Client sampling (paper §3.2: random without replacement, P{i∈S_t}=n/m).

Counterpart of ``repro.core.sampling``, drawing from an explicit
``torch.Generator``. The draws differ from the JAX PRNG's; parity tests
stage the JAX side's client ids instead."""
from __future__ import annotations

import torch


def sample_clients(generator: torch.Generator, m: int, n: int):
    """Returns int64 indices (n,) of the participating clients."""
    if n <= 0 or n >= m:
        return torch.arange(m, dtype=torch.int64)
    return torch.randperm(m, generator=generator)[:n]
