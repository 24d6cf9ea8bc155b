"""High-level facade: ``FederatedTrainer`` wires data, the loss, the
paper's algorithm and checkpointing into a ``run()`` loop — the entry point
the examples and users drive.

Counterpart of ``repro.core.api.FederatedTrainer`` with its simulation
backend (``mesh=None``: FedSim, any client count, the paper's semantics,
one device). The mesh backend is not ported: a non-None ``mesh`` raises.
``device`` picks where the state and the rounds run; ``None`` means CUDA
and raises without a card (pass ``device="cpu"`` to run on the CPU).

Client ids come from :func:`repro_torch.core.sampling.sample_clients` on a
``torch.Generator`` seeded with ``train.seed + 1``, so the ids differ from
the JAX trainer's (a JAX PRNG stream); each round also draws the seed of
its own generator from it — what the round's heterogeneous step counts
(``fed.local_steps_min``) draw from, as the JAX trainer hands each round
its own key — so a staged ``scan_rounds`` run draws what the per-round
loop draws.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.convert import state_to_jax
from repro_torch.core.sampling import sample_clients
from repro_torch.core.sim import FedSim


@dataclass
class FederatedTrainer:
    fed: FedConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    # simulation backend
    loss_fn: Optional[Callable] = None          # (params, batch) -> (loss, aux)
    init_params: Optional[object] = None        # nested dict of tensors
    data: Optional[object] = None               # needs .round_batches(...)
    # mesh backend (not ported)
    model: Optional[object] = None
    mesh: Optional[object] = None
    lm_data: Optional[object] = None
    # wire mode (fed.wire=True): optional custom comm.SimulatedNetwork
    network: Optional[object] = None
    device: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "FederatedTrainer(mesh=...): the mesh backend is not ported "
                "to repro_torch yet — pass mesh=None for the simulation "
                "backend")
        if self.loss_fn is None or self.init_params is None:
            raise ValueError(
                "the simulation backend (mesh=None) needs loss_fn and "
                "init_params")
        self.history: List[Dict] = []
        self._sim = FedSim(self.loss_fn, self.fed, network=self.network,
                           device=self.device)
        self._state = self._sim.init(self.init_params)

    @property
    def params(self):
        """The model as a nested dict in JAX shapes (views into the flat
        state)."""
        return self._sim.unravel(self._state.params)

    def _draw_round(self, gen: torch.Generator, r: int, batch_size: int):
        """Round ``r``'s client ids, batches and generator, drawn from the
        run's ``gen`` in the order the per-round loop and the staging
        share."""
        fed = self.fed
        n = fed.participating or fed.num_clients
        idx = np.asarray(sample_clients(gen, fed.num_clients, n))
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        batches = self.data.round_batches(idx, r, fed.local_steps, batch_size)
        return idx, batches, torch.Generator().manual_seed(seed)

    def run(self, rounds: Optional[int] = None, *, batch_size: int = 20,
            scan_rounds: int = 0,
            log: Optional[Callable[[str], None]] = print):
        """Train for ``rounds``. With ``scan_rounds=R > 1`` the trainer
        stages R rounds of client ids and batches at a time and runs them
        through ``FedSim.run_rounds`` (the same history as the per-round
        loop); otherwise one ``FedSim.round`` call a round. With
        ``train.checkpoint_every`` the state is saved to ``ckpt_round{r}``
        (in the working directory) where the JAX trainer saves it: after
        round r when r is a positive multiple, and under ``scan_rounds``
        once per chunk that crossed such a round, after the chunk's last
        round."""
        rounds = rounds or self.train.rounds
        gen = torch.Generator().manual_seed(self.train.seed + 1)
        ce = self.train.checkpoint_every
        t0 = time.time()

        def record(met, r):
            rec = {k: float(v) for k, v in met.items()}
            rec["round"] = r
            self.history.append(rec)
            if log and (r % self.train.log_every == 0 or r == rounds - 1):
                log(f"round {r:4d}  loss {rec['loss']:8.4f}  "
                    f"({time.time() - t0:.1f}s)")

        if scan_rounds and scan_rounds > 1:
            r = 0
            while r < rounds:
                chunk = min(scan_rounds, rounds - r)
                staged = [self._draw_round(gen, rr, batch_size)
                          for rr in range(r, r + chunk)]
                idx = np.stack([s[0] for s in staged])
                batches = {k: np.stack([s[1][k] for s in staged])
                           for k in staged[0][1]}
                self._state, mets = self._sim.run_rounds(
                    self._state, batches, idx, [s[2] for s in staged])
                for i, met in enumerate(mets):
                    record(met, r + i)
                r += chunk
                if ce and any(rr % ce == 0 and rr > 0
                              for rr in range(r - chunk, r)):
                    # only chunk-boundary states exist under staging:
                    # snapshot once per chunk that crossed a checkpoint round
                    self.save(f"ckpt_round{r - 1}")
            return self.history

        for r in range(rounds):
            idx, batches, rng = self._draw_round(gen, r, batch_size)
            self._state, met = self._sim.round(self._state, batches, idx, rng)
            record(met, r)
            if ce and r % ce == 0 and r > 0:
                self.save(f"ckpt_round{r}")
        return self.history

    def save(self, path: str):
        """Checkpoint the state in the JAX trainer's layout
        (``convert.state_to_jax``): ``repro.checkpoint.load_pytree`` reads
        it into a JAX trainer's state, and this package's ``load_pytree``
        reads a JAX trainer's checkpoint."""
        save_pytree(path, state_to_jax(self._state, self._sim.unravel),
                    {"round": len(self.history), "algo": self.fed.algorithm})
