"""The paper's contribution — FedAMS / FedCAMS — and its substrate
(counterpart of ``repro.core``, where ported): compressors, error
feedback, local-update rules, client sampling, server optimizers, the
round stages, the FedSim simulation backend and ``FederatedTrainer``.

The names resolve on first use (PEP 562): ``comm.wire`` and ``convert``
import submodules of this package, and the trainer imports them back, so
importing every submodule here would run that cycle half way."""
import importlib

_EXPORTS = {
    "FederatedTrainer": "api",
    "Compressor": "compressors", "Selection": "compressors",
    "make_compressor": "compressors", "randk_positions": "compressors",
    "selection_to_dense": "compressors",
    "ef_compress": "error_feedback", "ef_compress_masked": "error_feedback",
    "LocalUpdate": "local", "make_local_update": "local",
    "sample_clients": "sampling",
    "ServerState": "server_opt", "init_server_state": "server_opt",
    "server_update": "server_opt",
    "FedSim": "sim", "SimState": "sim",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    module = importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}")
    return getattr(module, name)
