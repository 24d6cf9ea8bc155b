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
raise unless the caller asks for ``device="cpu"``. Every per-round entry
point is one program per shape and setting, as the reference jits it:
``FedSim.round``, the async engine's dispatch and flush, and the mesh's
per-round step (``FederatedTrainer(mesh=...).run``, ``launch.train``) are
each one CUDA graph on the card, captured at the first call after one
dropped warm-up run and replayed once a call; ``FedSim.run_rounds`` (and
``FederatedTrainer.run(scan_rounds=R)``) runs R rounds as one program, as
the reference's scan does: one captured round, replayed R times, with one
host read at the end. On the CPU the same bodies run eagerly.
:func:`disable_graphs` (the counterpart of ``jax.disable_jit()``) makes
the per-round entry points call their eager function instead, on any
device.
"""
from __future__ import annotations

import contextlib
import contextvars

__version__ = "0.1.0"

#: false (in this thread or task) while :func:`disable_graphs` is open
_GRAPHS = contextvars.ContextVar("repro_torch_graphs", default=True)


@contextlib.contextmanager
def disable_graphs():
    """Within (in this thread or task): every per-round entry point calls
    its eager function on the caller's state and makes no program, as
    ``jax.disable_jit()`` makes the reference's jitted functions run op by
    op: ``FedSim.round`` its round, the async engine's steps
    ``FedSim._async_dispatch`` and ``FedSim._async_flush``, and
    ``MeshRounds.round`` the mesh round itself. The multi-round drivers
    (``FedSim.run_rounds``, ``MeshRounds`` called with R rounds) stay
    programs; their eager twin is the loop of per-round calls inside
    this. The kernels launch inside it as outside. Only a caller enters
    it: nothing in the package falls back to it."""
    token = _GRAPHS.set(False)
    try:
        yield
    finally:
        _GRAPHS.reset(token)


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _GRAPHS.get()


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
