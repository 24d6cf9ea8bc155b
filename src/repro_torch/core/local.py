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
  masked to no-ops on the device (no host read of ``k_i``).
* :func:`train_clients` — a block of clients as one batched program:
  ``torch.func.vmap`` of :func:`run_local_steps` over the clients, with the
  ``torch.func`` gradient of :func:`func_grad_fn` (the reference's
  ``jax.vmap`` over ``_local_train``). FedSim's local phase.
* :func:`train_clients_loop` — its plain twin: the same clients one after
  another, for tests and the card's comparison; nothing in the port calls
  it.
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
    in fp32 as the JAX schedule takes it. Computed on the host; FedSim
    hands it to the round as a 0-d fp32 tensor on the round's device, so a
    captured round reads each round's value rather than baking one in."""
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

    ``grad_fn(params, batch) -> (loss, grads)``; ``eta_l``: a float or a
    0-d tensor. ``k_i`` (an int or a 0-d integer tensor, moved to
    ``params``' device; FedSim stages it there) masks
    steps ``t >= k_i`` to no-ops with ``torch.where`` — params, carry and
    loss freeze — so the loop never reads ``k_i`` on the host, as the
    reference's scan takes a traced ``k_i``. Returns ``(local_params,
    mean_loss)``, the mean over the steps actually executed: a true
    division by the 0-d ``max(k_i, 1)``."""
    anchor = params
    p, c = params, rule.init_carry(params)
    k = next(iter(batches.values())).shape[0]
    if k_i is not None:
        k_i = torch.as_tensor(k_i, device=params.device)
    losses = []
    for t in range(k):
        loss, g = grad_fn(p, {key: val[t] for key, val in batches.items()})
        pn, cn = rule.step(p, c, g, eta_l, anchor)
        if k_i is None:
            p, c = pn, cn
            losses.append(loss)
            continue
        active = k_i > t
        p = torch.where(active, pn, p)
        if isinstance(c, torch.Tensor):
            c = torch.where(active, cn, c)
        losses.append(torch.where(active, loss, 0.0))
    losses = torch.stack(losses)
    if k_i is None:
        return p, losses.mean()
    return p, losses.sum() / k_i.clamp_min(1).to(losses.dtype)


def func_grad_fn(loss_fn: Callable, unravel: Callable) -> Callable:
    """``grad_fn(p, batch) -> (loss, grads)`` for :func:`run_local_steps`
    through ``torch.func.grad_and_value`` of ``loss_fn(unravel(p), batch)``
    (``loss_fn`` returns ``(loss, aux)``), which ``torch.func.vmap`` can
    batch; ``torch.autograd.grad`` cannot run under vmap."""
    grad_and_value = torch.func.grad_and_value(
        lambda p, batch: loss_fn(unravel(p), batch), has_aux=True)

    def grad_fn(p, batch):
        g, (loss, _) = grad_and_value(p, batch)
        return loss, g

    return grad_fn


def autograd_grad_fn(loss_fn: Callable, unravel: Callable) -> Callable:
    """The same ``grad_fn`` through ``torch.autograd.grad`` on one client:
    what :func:`train_clients_loop` ran as FedSim's local phase before the
    batched block, and what the mesh's ranks run."""

    def grad_fn(p, batch):
        p = p.detach().requires_grad_(True)
        loss, _ = loss_fn(unravel(p), batch)
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g

    return grad_fn


def train_clients(rule: LocalUpdate, grad_fn: Callable, flat0, batches,
                  eta_l, k_blk=None):
    """Local training for a block of c clients as ONE program:
    ``torch.func.vmap`` over the clients of :func:`run_local_steps` from
    the shared ``flat0``, each client on its row of ``batches`` (a dict of
    (c, K, ...) tensors) with its step count from ``k_blk`` ((c,) integer
    tensor, or None). ``grad_fn`` must be one vmap can batch
    (:func:`func_grad_fn`); ``flat0``, the prox anchor, and ``eta_l`` are
    shared. Returns ``((c, d) deltas local − flat0, (c,) mean losses)``."""

    def one(batch, k_i):
        local, loss = run_local_steps(rule, grad_fn, flat0, batch, eta_l,
                                      k_i)
        return local - flat0, loss

    return torch.func.vmap(one, in_dims=(0, None if k_blk is None else 0))(
        batches, k_blk)


def train_clients_loop(rule: LocalUpdate, grad_fn: Callable, flat0, batches,
                       eta_l, k_blk=None):
    """:func:`train_clients`' plain twin: the c clients one after another,
    each through :func:`run_local_steps`. Same arguments (any ``grad_fn``:
    :func:`autograd_grad_fn` too) and the same ``((c, d), (c,))`` pair."""
    n = next(iter(batches.values())).shape[0]
    deltas, losses = [], []
    for i in range(n):
        local, loss = run_local_steps(
            rule, grad_fn, flat0, {k: v[i] for k, v in batches.items()},
            eta_l, None if k_blk is None else k_blk[i])
        deltas.append(local - flat0)
        losses.append(loss)
    return torch.stack(deltas), torch.stack(losses)
