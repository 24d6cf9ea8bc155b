"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of their first steps (here, rounds):
each step's loss, the per-leaf norms of the first gradient as the
optimizer gets it, the per-leaf norms of the parameters' change after the
rounds, and the per-leaf norms of each error-feedback row the rounds
touched. The numbers that come out are each a gap between the two sides'
readings, never the norm of their difference:

* ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| over the steps;
* ``grad_gap_median`` / ``grad_gap_worst``: the median / largest over the
  leaves of a leaf's gradient gap, |norm - norm_ref| over the larger of
  that leaf's reference norm and the median leaf's;
* ``change_gap_median`` / ``change_gap_worst``: the same of the change,
  over the leaves whose reference gradient is over a thousandth of the
  median leaf's, and not 0 (a leaf the reference's gradient leaves at
  rounding moves by round-off alone);
* ``ef_gap_median`` / ``ef_gap_worst``: the same of the error rows, over
  every (row, moving leaf) pair, against the median pair's norm.

A cell's limits name the numbers it compares; the others are readings
(PERF.md says which and why). A number that is not finite (a side
diverged) is infinite, and fails.
"""
from __future__ import annotations

import math

import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the change's and the error rows' gaps
STILL_LEAF = 1e-3


def leaf_gaps(mine: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each leaf's |norm - norm_ref| over the larger of its reference norm
    and the median leaf's; not finite where a norm is not."""
    mine, ref = mine.double(), ref.double()
    floor = torch.maximum(ref, ref.median()).clamp_min(1e-300)
    gaps = (mine - ref).abs() / floor
    return torch.where(torch.isfinite(gaps), gaps, math.inf)


def _median(gaps: torch.Tensor) -> float:
    return float(gaps.median()) if gaps.numel() else 0.0


def _worst(gaps: torch.Tensor) -> float:
    return float(gaps.max()) if gaps.numel() else 0.0


def moving_leaves(ref: dict) -> torch.Tensor:
    g = ref["grad_norms"].double()
    return g > STILL_LEAF * g.median()


def _gaps(mine: dict, ref: dict) -> dict:
    """Each leaf's gap of the gradient and of the change, and each (row,
    leaf) gap of the error rows; a leaf that does not move counts 0 in the
    last two."""
    keep = moving_leaves(ref)
    change = leaf_gaps(mine["change_norms"], ref["change_norms"])
    e_ref = ref["ef_norms"].double()
    ef = torch.zeros_like(e_ref)
    ef[:, keep] = leaf_gaps(mine["ef_norms"].double()[:, keep].reshape(-1),
                            e_ref[:, keep].reshape(-1)).view(len(e_ref), -1)
    return {"grad": leaf_gaps(mine["grad_norms"], ref["grad_norms"]),
            "change": torch.where(keep, change, 0.0), "ef": ef, "keep": keep}


def training_gaps(mine: dict, ref: dict) -> dict:
    """``mine`` and ``ref``: ``losses`` (a list), ``grad_norms`` and
    ``change_norms`` (per leaf), ``ef_norms`` (per touched row and leaf,
    the rows in the same order). Returns every number above."""
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(mine["losses"], ref["losses"]))
    g = _gaps(mine, ref)
    change, ef = g["change"][g["keep"]], g["ef"][:, g["keep"]].reshape(-1)
    return {"loss_gap": loss_gap,
            "grad_gap_median": _median(g["grad"]),
            "grad_gap_worst": _worst(g["grad"]),
            "change_gap_median": _median(change),
            "change_gap_worst": _worst(change),
            "ef_gap_median": _median(ef),
            "ef_gap_worst": _worst(ef)}


def worst_leaves(mine: dict, ref: dict) -> dict:
    """Where the worst gaps lie: the index of the gradient's and of the
    change's worst leaf, and the (row, leaf) of the error rows' worst
    pair. A diagnosis, compared with nothing."""
    g = _gaps(mine, ref)
    at, leaves = int(g["ef"].argmax()), g["ef"].shape[1]
    return {"grad_worst_leaf": int(g["grad"].argmax()),
            "change_worst_leaf": int(g["change"].argmax()),
            "ef_worst_row": at // leaves, "ef_worst_leaf": at % leaves}
