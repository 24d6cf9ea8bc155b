"""The port's models: ``ParamDef`` trees and the flat-vector layout
(``params``), ConvMixer and the MLP (``convmixer``), and the model zoo's
attention-only family (``layers``, ``attention``, ``stack``, ``model``)."""
from repro_torch.models.model import Model, greedy_sample  # noqa: F401
from repro_torch.models.params import ParamDef  # noqa: F401
