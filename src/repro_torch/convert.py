"""Carry weights and server state across from the JAX package.

The JAX side hands over plain numpy arrays (``jax.device_get`` of its
pytrees), so this module needs neither ``jax`` nor ``repro``:

* :func:`params_from_jax` — a nested dict of arrays → the port's params (a
  nested dict of fp32 tensors in the same, JAX, shapes);
* :func:`model_params_from_jax` / :func:`model_params_to_jax` — a model
  zoo params tree (``repro.models.model.Model.init``, stacked group leaves
  included) to the port's ``models.model.Model`` params on a device, and
  back to numpy: the JAX init is not reproducible across processes (it
  keys leaves by Python's salted ``hash()``), so parity runs carry it
  across. At tp > 1 the JAX tree is global and each rank takes (and
  gives back) its model shards;
* :func:`flat_from_jax` — the same, raveled in ``ravel_pytree`` order;
* :func:`server_state_from_jax` — a FedSim ``ServerState`` over the flat
  vector (fp32, bf16 or int8 ``QuantState`` storage) → the port's;
* :func:`state_to_jax` — the port's ``SimState`` → the JAX ``SimState``'s
  layout (what ``FederatedTrainer.save`` writes), and
  :func:`state_from_jax`, its inverse: a JAX FedSim's state (a restored
  checkpoint, or ``jax.device_get(state._asdict())``) → the port's
  ``SimState``;
* :func:`mesh_state_to_jax` / :func:`mesh_state_from_jax` — the mesh's
  ``FedMeshState`` in the global layout (``core.mesh.gather_fed_state``,
  model shards and EF rows joined at any tp; ``shard_fed_state`` cuts it
  back) to and from the JAX ``FedMeshState._asdict()`` layout (what the mesh
  trainer's ``save`` writes; both packages start a parity run from one
  staged state with them).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.server_opt import QuantState, ServerState
from repro_torch.core.sim import SimState
from repro_torch.models.params import ravel


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` takes, including the
    ``ml_dtypes`` bfloat16 JAX uses, or a tensor) → a tensor of the same
    dtype, copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device).float()


def model_params_from_jax(tree, device=None, defs=None, ctx=None):
    """A JAX model params tree (nested dicts of arrays at their global
    shapes, e.g. ``jax.device_get(model.init(key))``) → the same tree of
    tensors on ``device`` (None: CUDA), every leaf copied with its dtype
    and shape; with ``defs`` and ``ctx`` (a rank of a mesh with a model
    axis), this rank's shards of it (``models.params.shard_params``)."""
    from repro_torch import resolve_device
    from repro_torch.models.params import take_shard, tree_map
    device = resolve_device(device)
    if ctx is not None:
        return tree_map(lambda a, d: tensor_from_numpy(
            take_shard(tensor_from_numpy(a), d, ctx), device).contiguous(),
            tree, defs)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_from_numpy(t, device)

    return conv(tree)


def model_params_to_jax(params, defs=None, ctx=None) -> dict:
    """The port's model params → nested dicts of numpy arrays (fp32), what
    ``jnp.asarray`` or ``repro.checkpoint.save_pytree`` takes; with
    ``defs`` and ``ctx``, this rank's shards gathered to the global tree
    first (collective: every rank of the mesh calls it)."""
    if ctx is not None:
        from repro_torch.models.params import gather_params
        params = gather_params(params, defs, ctx)
    if isinstance(params, dict):
        return {k: model_params_to_jax(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy().copy()


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


def state_to_jax(state, unravel) -> dict:
    """The port's ``SimState`` in the JAX ``SimState._asdict()`` layout:
    ``params`` a nested dict in JAX shapes (``unravel`` is the FedSim's),
    ``opt`` a ``ServerState`` (int8 v/v̂ as ``QuantState``), ``errors``,
    ``server_error``, ``x_client``, and ``bits``/``round`` as Python ints.
    Array leaves are copies on the CPU, as tensors: numpy has no bfloat16
    (``t.numpy()`` gives the array for every other state dtype)."""
    host = lambda t: t.detach().to("cpu", copy=True)

    def second(s):
        if isinstance(s, QuantState):
            return QuantState(q=host(s.q), scale=host(s.scale))
        return host(s)

    def tree(p):
        return ({k: tree(v) for k, v in p.items()} if isinstance(p, dict)
                else host(p))

    opt = state.opt
    return {
        "params": tree(unravel(state.params)),
        "opt": ServerState(m=host(opt.m), v=second(opt.v),
                           vhat=second(opt.vhat), t=host(opt.t)),
        "errors": host(state.errors),
        "server_error": host(state.server_error),
        "x_client": host(state.x_client),
        "bits": int(state.bits),
        "round": int(state.round),
    }


def state_from_jax(tree, device="cpu"):
    """A JAX FedSim state in the ``SimState._asdict()`` layout (numpy
    arrays, or tensors as :func:`state_to_jax` gives them) → the port's
    ``SimState`` on ``device``: the params raveled in ``ravel_pytree``
    order, every other array copied with its dtype."""
    return SimState(
        params=flat_from_jax(tree["params"], device),
        opt=server_state_from_jax(tree["opt"], device),
        errors=tensor_from_numpy(tree["errors"], device),
        server_error=tensor_from_numpy(tree["server_error"], device),
        x_client=tensor_from_numpy(tree["x_client"], device),
        bits=int(np.asarray(tree["bits"])),
        round=int(np.asarray(tree["round"])))


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def mesh_state_to_jax(state) -> dict:
    """A global-layout ``core.mesh.FedMeshState`` → the JAX
    ``FedMeshState._asdict()`` layout: ``params``, ``m``, ``v``, ``vhat``
    and ``errors`` nested dicts (``errors`` leaves (m, ...)) and ``round``,
    every leaf a CPU tensor copy (bf16 kept: numpy has none)."""
    return {name: _host_tree(getattr(state, name))
            for name in state._fields}


def mesh_state_from_jax(tree, device="cpu"):
    """A JAX ``FedMeshState`` (``jax.device_get(state._asdict())``, numpy
    leaves, or :func:`mesh_state_to_jax`'s) → the port's global-layout
    ``FedMeshState`` on ``device``, every leaf copied with its dtype."""
    from repro_torch.core.mesh import FedMeshState

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_from_numpy(t, device)

    return FedMeshState(**{name: conv(tree[name])
                           for name in FedMeshState._fields})
