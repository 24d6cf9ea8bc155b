"""Architecture registry: every assigned arch + the paper's own eval model.

Each arch module exposes ``SPEC: ArchSpec`` with the exact assigned config,
a reduced smoke config (<=2 layers, d_model<=512, <=4 experts), and the
policy knobs the launcher needs (hierarchical-FL mode for models whose
TP replica exceeds a pod slice; long_500k eligibility per DESIGN.md §4).

A copy of ``repro.configs.registry``; the ten ``configs/<arch>.py`` files
are copies of the JAX package's (tests/test_torch_models.py holds every
field against the originals). ``models.model.Model`` builds the
attention-only ones and refuses the rest by name.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "internvl2-1b",
    "deepseek-v3-671b",
    "qwen1.5-32b",
    "hubert-xlarge",
    "gemma2-27b",
    "qwen2-moe-a2.7b",
    "deepseek-coder-33b",
    "recurrentgemma-2b",
    "xlstm-350m",
    "gemma2-2b",
]


@dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    smoke: ModelConfig
    # "per_data": every index of the data axis is one FL client (default).
    # "per_pod": the whole pod slice is one client (hierarchical cross-silo
    #            mode for models whose TP replica exceeds 16 chips).
    client_mode: str = "per_data"
    # long_500k policy: "native" (sub-quadratic by architecture),
    # "variant" (sliding-window variant, flagged deviation), "skip".
    long_500k: str = "variant"
    has_decode: bool = True
    notes: str = ""


_CACHE: Dict[str, ArchSpec] = {}


def get_arch(name: str) -> ArchSpec:
    if name not in _CACHE:
        mod_name = name.replace("-", "_").replace(".", "_")
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        _CACHE[name] = mod.SPEC
    return _CACHE[name]


def all_archs() -> Dict[str, ArchSpec]:
    return {n: get_arch(n) for n in ARCH_IDS}
