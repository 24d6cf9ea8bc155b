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
raise unless the caller asks for ``device="cpu"``. ``FedSim.run_rounds``
(and ``FederatedTrainer.run(scan_rounds=R)``) runs R rounds as one
program, as the reference's scan does: on CUDA one captured CUDA graph of
a round, replayed R times, with one host read at the end; on the CPU the
same round body, run eagerly.
"""
from __future__ import annotations

__version__ = "0.1.0"


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
