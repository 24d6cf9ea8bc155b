"""Mesh construction.

Counterpart of ``repro.launch.mesh.make_mesh``: a ``DeviceMesh`` with one
named dim per JAX mesh axis (``init_device_mesh``). It needs the process
group first: every rank calls ``torch.distributed.init_process_group``
(its address, world size and rank given explicitly — nothing on the
machine announces a cluster), then ``make_mesh`` with the same arguments.
The mesh's size must equal the world size; ranks are laid out row-major
over ``shape``, as ``jax.make_mesh`` lays out devices.

The reference's per-chip roofline constants (``BACKEND_SPECS``) are a
TPU's and are not carried over.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape, axes, device="cuda"):
    """Arbitrary mesh over the initialized process group; ``device`` is
    where the ranks' tensors live (``"cuda"`` or ``"cpu"``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)
