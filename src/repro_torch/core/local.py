"""Pluggable local-update rules — how a client turns K gradients into its
delta. Counterpart of ``repro.core.local``.

The port trains each client on the flat (d,) parameter vector, so a rule's
``step`` maps flat tensors to flat tensors:

    sgd   : x ← x − η_l·g                  (paper Algorithm 1)
    sgdm  : u ← β·u + g;  x ← x − η_l·u    (heavy-ball local momentum)
    prox  : x ← x − η_l·(g + μ·(x − x₀))   (FedProx proximal term)

* :func:`local_lr` — the per-round local LR schedule (``eta_l_decay``).
* :func:`hetero_step_counts` — per-client step counts K_i ~ U{min..K},
  drawn from a ``torch.Generator`` (the JAX PRNG stream is not reproduced;
  parity tests hand both packages the same counts).
* :func:`run_local_steps` — the K-step loop, with steps ``t >= k_i``
  masked to no-ops.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import FedConfig


class LocalUpdate(NamedTuple):
    """A local optimizer rule: ``init_carry(params) -> carry`` and
    ``step(params, carry, grads, eta_l, anchor) -> (params, carry)``."""
    name: str
    init_carry: Callable
    step: Callable


def make_local_update(fed: FedConfig) -> LocalUpdate:
    """Build the configured local rule (``FedConfig.local_opt``)."""
    if fed.local_opt == "sgd":

        def init_carry(params):
            return ()

        def step(p, c, g, eta_l, anchor):
            return p - eta_l * g, ()

    elif fed.local_opt == "sgdm":
        beta = fed.local_momentum

        def init_carry(params):
            return torch.zeros_like(params)

        def step(p, u, g, eta_l, anchor):
            u = beta * u + g
            return p - eta_l * u, u

    elif fed.local_opt == "prox":
        mu = fed.prox_mu

        def init_carry(params):
            return ()

        def step(p, c, g, eta_l, anchor):
            return p - eta_l * (g + mu * (p - anchor)), ()

    else:  # unreachable: FedConfig validates local_opt at construction
        raise ValueError(f"unknown local_opt {fed.local_opt!r}")
    return LocalUpdate(fed.local_opt, init_carry, step)


def local_lr(fed: FedConfig, round_idx: int) -> float:
    """η_l for this round: ``eta_l · eta_l_decay^t``, the decay power taken
    in fp32 as the JAX schedule takes it."""
    if fed.eta_l_decay == 1.0:
        return fed.eta_l
    decay = torch.tensor(fed.eta_l_decay, dtype=torch.float32)
    return float(fed.eta_l * torch.pow(decay, float(round_idx)))


def hetero_step_counts(fed: FedConfig, generator: Optional[torch.Generator],
                       count: int) -> Optional[torch.Tensor]:
    """(count,) int64 per-client step counts K_i ~ U{local_steps_min..K}, or
    ``None`` when heterogeneity is off (``local_steps_min == 0``)."""
    if not fed.local_steps_min:
        return None
    if generator is None:
        raise ValueError("FedConfig.local_steps_min > 0 draws per-client step "
                         "counts: pass a torch.Generator")
    return torch.randint(fed.local_steps_min, fed.local_steps + 1, (count,),
                         generator=generator)


def run_local_steps(rule: LocalUpdate, grad_fn: Callable, params, batches,
                    eta_l, k_i=None):
    """K local steps of ``rule`` from the flat ``params`` over ``batches``
    (a dict of tensors with leading dim K).

    ``grad_fn(params, batch) -> (loss, grads)``. ``k_i`` (an int or a 0-d
    tensor) masks steps ``t >= k_i`` to no-ops — params, carry and loss
    freeze. Returns ``(local_params, mean_loss)``, the mean over the steps
    actually executed."""
    anchor = params
    p, c = params, rule.init_carry(params)
    k = next(iter(batches.values())).shape[0]
    losses = []
    for t in range(k):
        if k_i is not None and not t < int(k_i):
            losses.append(torch.zeros((), dtype=torch.float32,
                                      device=params.device))
            continue
        loss, g = grad_fn(p, {key: val[t] for key, val in batches.items()})
        p, c = rule.step(p, c, g, eta_l, anchor)
        losses.append(loss)
    losses = torch.stack(losses)
    if k_i is None:
        return p, losses.mean()
    return p, losses.sum() / max(int(k_i), 1)
