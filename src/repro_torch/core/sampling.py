"""Client sampling (paper §3.2: random without replacement, P{i∈S_t}=n/m).

Counterpart of ``repro.core.sampling``, drawing from an explicit
``torch.Generator``. The draws differ from the JAX PRNG's; parity tests
stage the JAX side's client ids, or patch the mesh's one draw
(:func:`participation_mask`, as ``core.mesh`` calls it) with the masks
they stage.

The mesh draws its masks on every rank from the same CPU generator
(:func:`round_generator` of the round seed), so every rank holds the same
mask with no collective — the role of JAX's shared per-round key."""
from __future__ import annotations

import numpy as np
import torch


def round_generator(seed: int, fold: int = 0) -> torch.Generator:
    """A CPU generator for one of mesh round ``seed``'s shared draws,
    ``fold`` telling the draws apart (JAX's ``fold_in``; the streams are
    not JAX's). The same on every rank and in every process."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                    int(fold) & 0xFFFFFFFF])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]) >> 1)


def sample_clients(generator: torch.Generator, m: int, n: int):
    """Returns int64 indices (n,) of the participating clients."""
    if n <= 0 or n >= m:
        return torch.arange(m, dtype=torch.int64)
    return torch.randperm(m, generator=generator)[:n]


def participation_mask(generator: torch.Generator, m: int, n: int):
    """(m,) float32 mask: 1.0 for sampled clients. Full participation if n
    in {0, m}."""
    if n <= 0 or n >= m:
        return torch.ones(m, dtype=torch.float32)
    mask = torch.zeros(m, dtype=torch.float32)
    mask[sample_clients(generator, m, n)] = 1.0
    return mask


def weighted_participation_mask(generator: torch.Generator, weights, n: int):
    """Gumbel top-n sampling without replacement with probability ∝
    weights (on the CPU, where the generator draws)."""
    weights = torch.as_tensor(weights, dtype=torch.float32).cpu()
    m = weights.shape[0]
    if n <= 0 or n >= m:
        return torch.ones(m, dtype=torch.float32)
    u = torch.rand(m, generator=generator).clamp_min(
        torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u)) + torch.log(weights.clamp_min(1e-30))
    mask = torch.zeros(m, dtype=torch.float32)
    mask[torch.topk(g, n).indices] = 1.0
    return mask
