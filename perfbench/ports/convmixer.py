"""The program's ConvMixer: its loss over a params dict, as
``FedSim`` takes it."""
from __future__ import annotations


def loss_fn(model: dict):
    """``loss(params, batch) -> (loss, aux)`` of the port's ConvMixer at the
    configuration's sizes."""
    from repro_torch.models import convmixer as cm
    cfg = cm.ConvMixerConfig(**model)
    return lambda p, batch: cm.convmixer_loss(p, batch, cfg)
