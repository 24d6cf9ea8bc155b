"""Plain-PyTorch FedCAMS rounds (Wang, Lin & Chen, ICML 2022, Algorithm 2):
the benchmark's reference for a federated round on one flat float32
parameter vector.

A round: each client of the cohort, one after another, runs K steps of
plain SGD at η_l from the server's model on its own batches; its delta
plus its error-feedback row is compressed by blockwise top-k (blocks cut
from the flat vector, |value| descending, ties to the lowest position),
the row keeps what was not sent; the server averages what the clients sent
over the cohort and takes one FedAMS step (Option 1: v̂ = max(v̂, v, ε),
x ← x + η·m/√v̂; Option 2: v̂ = max(v̂, v), x ← x + η·m/(√v̂ + ε)).

Nothing here comes from the program: the reference is given the inputs the
benchmark made (the initial vector, the cohorts and their batches) and a
``loss_and_grad(flat, batch)`` of the reference model, and works out all
else. It refuses a setting it does not model rather than guess.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: ``FedConfig`` fields and the only values the reference models; a mix
#: that sets another value is refused
MODELLED = {"algorithm": ("fedcams",), "compressor": ("blocktopk", "topk"),
            "local_opt": ("sgd",), "local_steps_min": (0,),
            "eta_l_decay": (1.0,), "two_way": (False,), "fault": (None,),
            "deadline_s": (0.0,), "server_state_dtype": ("float32",),
            "wire_value_dtype": ("float32",), "delta_dtype": ("float32",),
            "async_buffer": (0,), "option": (1, 2)}


def check_modelled(fed: dict) -> None:
    for key, allowed in MODELLED.items():
        if key in fed and fed[key] not in allowed:
            raise ValueError(f"the reference does not model {key}="
                             f"{fed[key]!r} (only {allowed})")
    for key in MODELLED:
        if key not in fed and key in ("algorithm", "compressor", "option"):
            raise ValueError(f"the traffic mix must state {key}")


def blocktopk_mask(tot: torch.Tensor, ratio: float, block: int):
    """Which positions of ``tot`` (d,) blockwise top-k sends: blocks of
    ``min(block, d rounded up to 128)`` values, the last zero-padded, and
    ``max(1, round(ratio · block size))`` picks a block by |value|,
    ties to the lowest position."""
    d = tot.numel()
    bs = min(block, -(-d // 128) * 128)
    nb = -(-d // bs)
    k = max(1, int(round(ratio * bs)))
    mag = F.pad(tot.abs(), (0, nb * bs - d)).view(nb, bs)
    picks = torch.sort(mag, dim=1, descending=True, stable=True).indices[:, :k]
    mask = torch.zeros(nb, bs, dtype=torch.bool, device=tot.device)
    mask.scatter_(1, picks, True)
    return mask.view(-1)[:d]


class FedCAMS:
    """The server's state (x, m, v, v̂) and the clients' error rows, kept
    for the clients a round has seen."""

    def __init__(self, x0: torch.Tensor, fed: dict, segments=None):
        check_modelled(fed)
        if fed["compressor"] == "topk" and segments is None:
            raise ValueError("the reference models top-k only as the mesh "
                             "runs it, blockwise within each leaf")
        self.fed = fed
        #: the lengths of the flat vector's parts that blockwise top-k cuts
        #: its blocks from each on its own (the mesh: each leaf); None, the
        #: whole vector as one
        self.segments = segments
        self.x = x0.detach().to(torch.float32).clone()
        z = lambda: torch.zeros_like(self.x)
        self.m, self.v, self.vhat = z(), z(), z()
        self.errors = {}

    def round(self, ids, batches: dict, loss_and_grad):
        """One round over the cohort ``ids`` with ``batches`` (leading
        (n, K)) on the device of x. Returns ``(mean loss, aggregate)``: the
        cohort's mean of each client's mean step loss, and the averaged
        compressed deltas the server stepped on."""
        f = self.fed
        eta_l, k_steps = f["eta_l"], f["local_steps"]
        agg = torch.zeros_like(self.x)
        losses = []
        for i, c in enumerate(int(c) for c in ids):
            p = self.x
            steps = []
            for k in range(k_steps):
                batch = {key: torch.as_tensor(v[i, k]).to(self.x.device)
                         for key, v in batches.items()}
                loss, g = loss_and_grad(p, batch)
                p = p - eta_l * g
                steps.append(loss)
            losses.append(torch.stack(steps).mean())
            tot = self.errors.get(c, torch.zeros_like(self.x)) + (p - self.x)
            sent = torch.cat([
                blocktopk_mask(part, f["compress_ratio"], f["wire_block"])
                for part in torch.split(tot, self.segments or [tot.numel()])])
            agg += torch.where(sent, tot, 0.0)
            self.errors[c] = torch.where(sent, 0.0, tot)
        agg = agg / len(losses)
        b1, b2, eps, eta = f["beta1"], f["beta2"], f["eps"], f["eta"]
        self.m = b1 * self.m + (1 - b1) * agg
        self.v = b2 * self.v + (1 - b2) * (agg * agg)
        if f["option"] == 1:
            self.vhat = torch.maximum(self.vhat, self.v).clamp_min(eps)
            self.x = self.x + eta * self.m / torch.sqrt(self.vhat)
        else:
            self.vhat = torch.maximum(self.vhat, self.v)
            self.x = self.x + eta * self.m / (torch.sqrt(self.vhat) + eps)
        return torch.stack(losses).mean(), agg


def leaf_norms(flat: torch.Tensor, sizes: list) -> torch.Tensor:
    """The L2 norm of each leaf of ``flat``, cut in ``sizes``, in float64."""
    return torch.stack([torch.linalg.vector_norm(part.double())
                        for part in torch.split(flat, sizes)])


def rounds(x0, fed: dict, plan: list, loss_and_grad, sizes: list,
           segments=None) -> dict:
    """The first ``len(plan)`` rounds from ``x0`` over ``plan`` (a list of
    ``(ids, batches)``): what the comparison reads — each round's mean
    loss, the per-leaf norms of the first round's aggregate (the pseudo-
    gradient the server's optimizer gets first), of the parameters'
    change over all the rounds and of the error row of each client the
    rounds touched (rows by client id, ascending)."""
    run = FedCAMS(x0, fed, segments)
    losses, first = [], None
    for ids, batches in plan:
        loss, agg = run.round(ids, batches, loss_and_grad)
        losses.append(float(loss))
        if first is None:
            first = agg
    return {"losses": losses, "grad_norms": leaf_norms(first, sizes).cpu(),
            "change_norms": leaf_norms(run.x - x0, sizes).cpu(),
            "ef_norms": torch.stack([leaf_norms(run.errors[c], sizes).cpu()
                                     for c in sorted(run.errors)])}


def touched_clients(plan: list) -> list:
    """The ids of the clients whose error rows ``plan``'s rounds touch,
    ascending: the rows of ``rounds``' ``ef_norms``."""
    return sorted({int(c) for ids, _ in plan for c in ids})


def leaf_sizes(layout: list) -> list:
    return [math.prod(shape) for _, shape, _, _ in layout]
