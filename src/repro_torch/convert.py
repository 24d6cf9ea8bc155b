"""Carry weights and server state across from the JAX package.

The JAX side hands over plain numpy arrays (``jax.device_get`` of its
pytrees), so this module needs neither ``jax`` nor ``repro``:

* :func:`params_from_jax` — a nested dict of arrays → the port's params (a
  nested dict of fp32 tensors in the same, JAX, shapes);
* :func:`flat_from_jax` — the same, raveled in ``ravel_pytree`` order;
* :func:`server_state_from_jax` — a FedSim ``ServerState`` over the flat
  vector (fp32, bf16 or int8 ``QuantState`` storage) → the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.server_opt import QuantState, ServerState
from repro_torch.models.params import ravel


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` takes, including the
    ``ml_dtypes`` bfloat16 JAX uses) → a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device).float()


def flat_from_jax(tree, device="cpu") -> torch.Tensor:
    return ravel(params_from_jax(tree, device))[0]


def _second_moment(s, device):
    if hasattr(s, "q") and hasattr(s, "scale"):
        return QuantState(q=tensor_from_numpy(s.q, device),
                          scale=tensor_from_numpy(s.scale, device))
    return tensor_from_numpy(s, device)


def server_state_from_jax(opt, device="cpu") -> ServerState:
    """``opt``: an object with ``m``, ``v``, ``vhat``, ``t`` fields holding
    flat arrays (``v``/``vhat`` may be QuantState-like with ``q``/``scale``).
    """
    return ServerState(
        m=tensor_from_numpy(opt.m, device),
        v=_second_moment(opt.v, device),
        vhat=_second_moment(opt.vhat, device),
        t=torch.tensor(int(np.asarray(opt.t)), dtype=torch.int32,
                       device=device))
