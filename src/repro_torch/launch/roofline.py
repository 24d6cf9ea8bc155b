"""Roofline terms of one rank's step.

Counterpart of ``repro.launch.roofline``. Three terms per (arch × shape ×
mesh):

    compute    = FLOPs_per_card / peak_flops_bf16
    memory     = bytes_per_card / hbm_bw
    collective = Σ collective_bytes × factor / ici_bw_per_link

The constants come from a :class:`~repro_torch.launch.mesh.BackendSpec`
(``launch.mesh.BACKEND_SPECS``; the default ``h100_sxm``: 989e12 /
3.35e12 / 450e9), overridable per call via ``spec=`` or globally via the
``REPRO_BACKEND`` env var. The counts are rank 0's
(``launch/op_analysis``): every rank of the mesh runs the same local
shapes, so they are per card. Collective bytes are weighted by the ring
convention all-reduce ≈ 2× payload and 1× otherwise.

The reference's ``parse_collectives`` reads compiled HLO text and has no
counterpart: the port charges collectives where they run
(``op_analysis.record_collective``). :class:`CollectiveStats` stays as
the by-kind container :func:`roofline_from` reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.launch.mesh import BackendSpec, backend_spec


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def weighted_bytes(self) -> float:
        total = 0.0
        for kind, b in self.bytes_by_kind.items():
            total += b * (2.0 if kind == "all-reduce" else 1.0)
        return total


@dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (HLO flops × chips)
    chips: int

    def to_dict(self):
        return dict(self.__dict__)


def model_flops_for(cfg, shape_kind: str, tokens: float, local_steps: int = 1):
    """Analytic MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D fwd."""
    n_active = cfg.num_active_params()
    if shape_kind == "train":
        return 6.0 * n_active * tokens * local_steps
    return 2.0 * n_active * tokens


def roofline_from_cost(cost, *, chips: int, model_flops: float,
                       spec: BackendSpec | None = None) -> Roofline:
    """The roofline of an ``op_analysis.StepCost`` (or any record with
    ``flops``, ``bytes`` and ``weighted_coll_bytes``); the counterpart of
    ``roofline_from_hlo``.
    ``spec`` None resolves the default (``REPRO_BACKEND``, else
    ``h100_sxm``)."""
    return _mk_roofline(cost.flops, cost.bytes, cost.weighted_coll_bytes,
                        chips=chips, model_flops=model_flops, spec=spec)


def roofline_from(cost: Dict, stats: CollectiveStats, *, chips: int,
                  model_flops: float,
                  spec: BackendSpec | None = None) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = stats.weighted_bytes
    return _mk_roofline(flops, hbm, coll, chips=chips,
                        model_flops=model_flops, spec=spec)


def _mk_roofline(flops, hbm, coll, *, chips: int, model_flops: float,
                 spec: BackendSpec | None = None) -> Roofline:
    spec = spec or backend_spec()
    compute_s = flops / spec.peak_flops_bf16
    memory_s = hbm / spec.hbm_bw
    collective_s = coll / spec.ici_bw_per_link
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / max(flops * chips, 1.0)
    return Roofline(flops_per_chip=flops, hbm_bytes_per_chip=hbm,
                    collective_bytes=coll, compute_s=compute_s,
                    memory_s=memory_s, collective_s=collective_s,
                    dominant=dominant, model_flops=model_flops,
                    useful_ratio=useful, chips=chips)
