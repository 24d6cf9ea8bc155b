"""Mesh-axis plumbing over ``torch.distributed`` (counterpart of
``repro.sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    AttnDims,
    ParallelContext,
    attn_dims,
    pad_to,
    padded_vocab,
)
