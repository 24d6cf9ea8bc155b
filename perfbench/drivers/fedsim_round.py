"""Driver ``fedsim_round``: federated rounds through the port's
``FedSim.round``, as a user of ``FederatedTrainer`` runs them.

Set-up builds one ``FedSim`` and its state from the configuration (the
model's family names the port's loss, ``perfbench/ports/<family>.py``, and
the reference model, ``perfbench/reference/<family>.py``) and the traffic
mix (``fed``: ``FedConfig``'s fields), makes the weights on the device from
the seed and pre-draws the mix's pool of rounds. It then drives that same
FedSim through its first three rounds, through the window's own call, on
three distinct cohorts and batches: the first call builds and captures
the round's program, so the window replays it. What those rounds leave
(their losses, the server's momentum after the first, the parameters and
the touched clients' error rows after the third) is what the comparison
reads.

A window call is one round on the pool's next cohort, cycling through the
pool; its read is the host read of the round's metrics.
"""
from __future__ import annotations

import gc
import importlib
import math

import torch

from perfbench.drivers.common import Clock, make_weights, nested
from perfbench.reference import fedcams as ref_fedcams
from perfbench.reference.compare import training_gaps
from perfbench.reference.precision import full_float32
from perfbench.traffic.generator import federated_rounds

#: the rounds set-up drives and the reference follows
CHECK_ROUNDS = 3


class Driver:
    def __init__(self, cell, seed: int, device):
        from repro_torch.configs.base import FedConfig
        from repro_torch.core.sim import FedSim

        clock = Clock()
        family = self.family = cell.config["family"]
        self.batch = cell.traffic["batch"]
        self.model = cell.config["model"]
        self.ref_model = importlib.import_module(
            f"perfbench.reference.{family}")
        port = importlib.import_module(f"perfbench.ports.{family}")
        self.layout = self.ref_model.layout(self.model)
        self.sizes = ref_fedcams.leaf_sizes(self.layout)
        self.fed = dict(cell.traffic["fed"])
        ref_fedcams.check_modelled(self.fed)
        clock.lap("imports")
        self.pool = federated_rounds(cell.traffic, seed,
                                     cell.traffic["pool_rounds"])
        clock.lap("traffic pool")
        if len(self.pool) <= CHECK_ROUNDS:
            raise ValueError("the pool must hold more rounds than the "
                             f"{CHECK_ROUNDS} set-up drives")
        self.x0 = make_weights(self.layout, seed, device)
        self.sim = FedSim(port.loss_fn(self.model), FedConfig(**self.fed),
                          device=device)
        st = self.sim.init(nested(self.layout, self.x0))
        clock.lap("weights and state")
        losses = []
        for ids, batches in self.pool[:CHECK_ROUNDS]:
            st, met = self.sim.round(st, batches, ids)
            losses.append(float(met["loss"]))
            clock.lap(f"round {len(losses) - 1}")
            if len(losses) == 1:
                first = (st.opt.m / (1 - self.fed["beta1"])).cpu()
        rows = ref_fedcams.touched_clients(self.pool[:CHECK_ROUNDS])
        errors = st.errors[torch.tensor(rows, device=st.errors.device)]
        self.mine = {"losses": losses,
                     "grad_norms": ref_fedcams.leaf_norms(first, self.sizes),
                     "change_norms": ref_fedcams.leaf_norms(
                         st.params - self.x0, self.sizes).cpu(),
                     "ef_norms": torch.stack([ref_fedcams.leaf_norms(
                         row, self.sizes).cpu() for row in errors])}
        self.state, self.r = st, CHECK_ROUNDS
        self._ref = None
        #: seconds of each part of set-up after the process's imports
        self.setup_parts = clock.parts

    def call(self):
        """One round: the window's timed call."""
        ids, batches = self.pool[self.r % len(self.pool)]
        self.state, met = self.sim.round(self.state, batches, ids)
        self.r += 1
        return met

    @staticmethod
    def read(met) -> bool:
        """The host read of a round's metrics; false if the loss is not
        finite (the round failed)."""
        loss, _ = float(met["loss"]), float(met["gamma"])
        return math.isfinite(loss)

    def flops_per_round(self):
        """The model FLOPs of one round's local training
        (``perfbench/counts/<family>.py``)."""
        counts = importlib.import_module(f"perfbench.counts.{self.family}")
        fed = self.fed
        images = fed["participating"] * fed["local_steps"] * self.batch
        return images * counts.train_flops_per_example(self.model)

    def release(self) -> None:
        """Frees the program and its state: the reference runs after."""
        import repro_torch
        self.sim = self.state = None
        repro_torch.clear_caches()
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> dict:
        """The reference's readings of the first rounds, from the same
        weights and rounds (TF32: the control)."""
        full_float32()
        lg = lambda flat, batch: self.ref_model.loss_and_grad(
            flat, batch, self.model, tf32)
        return ref_fedcams.rounds(self.x0, self.fed,
                                  self.pool[:CHECK_ROUNDS], lg, self.sizes)

    def check(self) -> dict:
        """The numbers compared: the program's readings against the
        float32 reference's."""
        if self._ref is None:
            self._ref = self.reference()
        return training_gaps(self.mine, self._ref)

    def control_readings(self) -> dict:
        """The TF32 reference's readings, the control's."""
        return self.reference(tf32=True)

    def control(self) -> dict:
        """The numbers compared with the TF32 reference in the program's
        place."""
        if self._ref is None:
            self._ref = self.reference()
        return training_gaps(self.control_readings(), self._ref)
