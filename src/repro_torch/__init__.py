"""FedCAMS (Communication-Efficient Adaptive Federated Learning, ICML 2022)
in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

This package is the PyTorch port of the JAX package ``repro``. It mirrors
``repro``'s module names so each counterpart is easy to find, and imports
neither ``jax`` nor anything of ``repro``:

    repro_torch.configs.base      — ``FedConfig``, ``TrainConfig`` (copies,
                                    same fields)
    repro_torch.data.synthetic    — ``FederatedClassification`` (a copy)
    repro_torch.models            — ``ParamDef``/ravel order, ConvMixer, MLP
    repro_torch.core              — compressors (randk included), error
                                    feedback, server optimizers, local
                                    rules, sampling, round stages, FedSim
                                    (faults, two-way downlink, the EF
                                    store, client chunks, grouped
                                    aggregation, async rounds),
                                    ``FederatedTrainer`` (``core.api``),
                                    the ``core.rounds`` façade
    repro_torch.comm              — wire codecs, simulated network,
                                    ``CommLog``, fault model and
                                    validation (``comm.faults``), the
                                    async buffered engine
                                    (``comm.async_engine``)
    repro_torch.checkpoint        — ``save_pytree``/``load_pytree`` (the
                                    JAX package's file format) and the
                                    host-side ``EFStore``
    repro_torch.kernels           — CUDA kernels (``csrc/``), their plain
                                    PyTorch twins (``ref``) and the
                                    per-call dispatch (``ops``)
    repro_torch.convert           — JAX params/state (as numpy) → the port,
                                    and the port's state → the JAX layout

Entry points take ``device=`` and default to CUDA; without a card they
raise unless the caller asks for ``device="cpu"``. Every jitted entry
point of the reference is one program per shape and setting here:
``FedSim.round``, the async engine's dispatch and flush, and the mesh's
per-round step (``FederatedTrainer(mesh=...).run``, ``launch.train``,
the step builders' train step ``launch.programs.TrainStep`` and the LM
example) are
each one CUDA graph on the card, captured at the first call after one
dropped warm-up run and replayed once a call; ``FedSim.run_rounds`` (and
``FederatedTrainer.run(scan_rounds=R)``) and ``MeshRounds`` called with R
rounds run R rounds as one program, as the reference's scan does: one
captured round, replayed R times, with one host read at the end; serving's
prefill and decode (``launch.programs``: ``launch.serve.generate``, the
step builders of ``launch.steps``) are one graph each per shape, sharing
one pool, with the decode position on the device. On the CPU the same
bodies run eagerly. :func:`disable_graphs` (the counterpart of
``jax.disable_jit()``) makes every one of them call its eager function
instead, on any device; :func:`clear_caches` (``jax.clear_caches()``)
drops every program built so far.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref

__version__ = "0.1.0"

#: false (in this thread or task) while :func:`disable_graphs` is open
_GRAPHS = contextvars.ContextVar("repro_torch_graphs", default=True)


#: the live objects that keep programs (FedSim, MeshRounds, serving's
#: program caches), each with a ``clear_programs()``; held weakly, so that
#: registering keeps nothing alive
_CACHES = weakref.WeakSet()


@contextlib.contextmanager
def disable_graphs():
    """Within (in this thread or task): every program-making entry point
    calls its eager function on the caller's state and makes no program,
    as ``jax.disable_jit()`` makes the reference's jitted functions run op
    by op: ``FedSim.round`` its round, the async engine's steps
    ``FedSim._async_dispatch`` and ``FedSim._async_flush``,
    ``MeshRounds.round`` (and so the step builders' train step) the mesh
    round itself, the multi-round drivers
    (``FedSim.run_rounds``, ``MeshRounds`` called with R rounds) R of
    those rounds one after another, and serving
    (``launch.serve.generate``, the step builders' ``fn``) the model's
    prefill and decode step op by op. The kernels launch inside it as
    outside. Only a caller enters it: nothing in the package falls back
    to it."""
    token = _GRAPHS.set(False)
    try:
        yield
    finally:
        _GRAPHS.reset(token)


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _GRAPHS.get()


def register_programs(owner):
    """Makes ``owner``'s programs dropped by :func:`clear_caches` (it has
    a ``clear_programs()``) for as long as it lives; returns it."""
    _CACHES.add(owner)
    return owner


def clear_caches() -> None:
    """Drops every program that a live ``FedSim``, ``MeshRounds`` or
    serving program cache holds, with its CUDA graph and its memory pool,
    as ``jax.clear_caches()`` drops the reference's executables: once no
    caller holds a program's tensors, ``torch.cuda.empty_cache()`` hands
    the bytes back to the card. A later call builds its program again.

    It also drops cuBLAS's workspaces: cuBLAS keeps one for each (handle,
    stream) that ran a matmul, for the process's life, and every mesh
    program runs on a stream of its own. A later matmul allocates its
    workspace again."""
    import torch

    for owner in list(_CACHES):
        owner.clear_programs()
    if torch.cuda.is_initialized():
        torch._C._cuda_clearCublasWorkspaces()


def resolve_device(device=None):
    """``device`` (None, a string or a ``torch.device``) → ``torch.device``.

    ``None`` means CUDA. Asking for CUDA without a card raises: the port
    never falls back to the CPU on its own. On CUDA, TF32 is turned off for
    both cuDNN convolutions and matmuls, so float32 math stays float32 (the
    JAX reference computes in full float32)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA was requested but torch.cuda.is_available() "
                "is False — pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
