"""High-level facade: ``FederatedTrainer`` wires data, the loss, the
paper's algorithm and checkpointing into a ``run()`` loop — the entry point
the examples and users drive.

Counterpart of ``repro.core.api.FederatedTrainer``, with both backends:

* ``mesh=None`` — FedSim: any client count, the paper's semantics, one
  device (the async buffered engine and the EF store included);
* ``mesh=...`` — the mesh round of ``core.mesh`` on a
  ``torch.distributed`` ``DeviceMesh`` (``launch.mesh.make_mesh``): every
  rank builds the trainer after ``init_process_group`` and calls ``run``
  (and ``save``) alike; each index of the client axes is one client. It
  needs ``model`` and ``lm_data`` (with ``mesh_batch(round, K,
  global_batch, seq_len)``), runs at any size of the mesh's ``"model"``
  dim (the model must be built at that tp; each rank holds its model
  shards, and ``save`` gathers them) and hands the round a
  ``kernels.ops.KernelImpl``
  on the state's device: the kernels on CUDA, the plain paths on the CPU,
  as ``"auto"`` resolves them.

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
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.convert import mesh_state_to_jax, state_to_jax
from repro_torch.core import mesh as meshmod
from repro_torch.core.sampling import sample_clients
from repro_torch.core.sim import FedSim
from repro_torch.kernels.ops import KernelImpl
from repro_torch.sharding.rules import ParallelContext


@dataclass
class FederatedTrainer:
    fed: FedConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    # simulation backend
    loss_fn: Optional[Callable] = None          # (params, batch) -> (loss, aux)
    init_params: Optional[object] = None        # nested dict of tensors
    data: Optional[object] = None               # needs .round_batches(...)
    # mesh backend
    model: Optional[object] = None
    mesh: Optional[object] = None
    lm_data: Optional[object] = None
    # wire mode (fed.wire=True): optional custom comm.SimulatedNetwork
    network: Optional[object] = None
    device: Optional[object] = None

    def __post_init__(self):
        self.history: List[Dict] = []
        if self.mesh is not None:
            self._init_mesh()
            return
        if self.loss_fn is None or self.init_params is None:
            raise ValueError(
                "the simulation backend (mesh=None) needs loss_fn and "
                "init_params")
        self.history: List[Dict] = []
        self._sim = FedSim(self.loss_fn, self.fed, network=self.network,
                           device=self.device)
        self._state = self._sim.init(self.init_params)

    def _init_mesh(self):
        if self.network is not None:
            raise ValueError(
                "network= is a simulation-backend (mesh=None) feature; "
                "the mesh path reports measured wire_up_bytes but does "
                "not simulate transport")
        if self.fed.async_buffer:
            raise ValueError(
                "fed.async_buffer is a simulation-backend (mesh=None) "
                "feature — the event-driven buffered engine drives "
                "FedSim's transport simulation (DESIGN.md §11)")
        if self.model is None or self.lm_data is None:
            raise ValueError("the mesh backend needs model and lm_data")
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        tp = int(sizes.get("model", 1))
        if getattr(self.model, "tp", 1) != tp:
            raise ValueError(f"the model is built for tp="
                             f"{getattr(self.model, 'tp', 1)} but the mesh's "
                             f"model axis is {tp}")
        hierarchical = "data" not in self.fed.client_axes
        self._ctx = ParallelContext(
            model_axis="model" if "model" in sizes else None, tp=tp,
            data_axis="data" if (hierarchical and "data" in sizes) else None,
            dp=int(sizes.get("data", 1)) if hierarchical else 1,
            client_axes=self.fed.client_axes,
            num_clients=self.fed.num_clients,
            tp_collective=self.train.tp_collective, mesh=self.mesh)
        self._device = resolve_device(self.device)
        self._rnd = meshmod.build_fed_round(
            self.model, self.fed, self.train, self._ctx,
            kernel_impl=KernelImpl(device=self._device))
        self._scan = None
        self._state = meshmod.init_fed_state(
            self.model, self.fed, torch.Generator().manual_seed(
                self.train.seed), self._ctx, self._device)

    @property
    def params(self):
        """The model as a nested dict in JAX shapes (views into the flat
        state; on the mesh, this rank's replica)."""
        if self.mesh is not None:
            return self._state.params
        return self._sim.unravel(self._state.params)

    def _mesh_batch(self, batch, staged: bool = False):
        return meshmod.shard_batch(batch, self.model, self.fed, self.train,
                                   self._ctx, self._device, staged=staged)

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
        loop; with ``fed.ef_store`` its loop prefetches each next round's
        EF rows); otherwise one ``FedSim.round`` call a round. With
        ``fed.async_buffer`` the whole run is staged at once and the
        history holds one row a flush. With
        ``train.checkpoint_every`` the state is saved to ``ckpt_round{r}``
        (in the working directory) where the JAX trainer saves it: after
        round r when r is a positive multiple, and under ``scan_rounds``
        once per chunk that crossed such a round, after the chunk's last
        round."""
        rounds = rounds or self.train.rounds
        if self.mesh is not None:
            return self._run_mesh(rounds, scan_rounds, log)
        gen = torch.Generator().manual_seed(self.train.seed + 1)
        ce = self.train.checkpoint_every
        t0 = time.time()
        if self.fed.async_buffer:
            # the async engine consumes ALL staged cohorts in one run_rounds
            # call — its flush count need not equal the cohort count — so
            # the whole run is one chunk; ``rounds`` then counts dispatched
            # cohorts and the history rows are flushes (max(·, 2) keeps a
            # single round on the staged path, which the engine needs)
            scan_rounds = max(rounds, 2)

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

    def _run_mesh(self, rounds: int, scan_rounds: int, log):
        """The mesh loop: one ``fed_round`` call a round on this rank's
        shard of ``lm_data.mesh_batch`` (seed = the round index, as the
        JAX trainer's), or with ``scan_rounds=R > 1`` R staged rounds at a
        time through ``build_fed_rounds_scan`` (the same history): one
        program, kept with the trainer, that on CUDA + NCCL replays one
        captured round R times and reads the metrics once a chunk (the
        state is its carry). Checkpoints as the simulation loop writes
        them; only rank 0 logs."""
        fed, train = self.fed, self.train
        ce = train.checkpoint_every
        log = log if dist.get_rank() == 0 else None
        t0 = time.time()

        def record(met, r):
            rec = {k: float(v) for k, v in met.items()}
            rec["round"] = r
            self.history.append(rec)
            if log and (r % train.log_every == 0 or r == rounds - 1):
                log(f"round {r:4d}  loss {rec['loss']:8.4f}  "
                    f"({time.time() - t0:.1f}s)")

        if scan_rounds and scan_rounds > 1:
            if self._scan is None:
                self._scan = meshmod.build_fed_rounds_scan(self._rnd, log)
            step = self._scan
            r = 0
            while r < rounds:
                chunk = min(scan_rounds, rounds - r)
                batches, seeds = meshmod.stage_mesh_rounds(
                    self.lm_data, r, chunk, fed.local_steps,
                    train.global_batch, train.seq_len)
                self._state, stacked = step(
                    self._state, self._mesh_batch(batches, staged=True),
                    seeds)
                for i in range(chunk):
                    record({k: v[i] for k, v in stacked.items()}, r + i)
                r += chunk
                if ce and any(rr % ce == 0 and rr > 0
                              for rr in range(r - chunk, r)):
                    self.save(f"ckpt_round{r - 1}")
            return self.history

        for r in range(rounds):
            raw = self.lm_data.mesh_batch(r, fed.local_steps,
                                          train.global_batch, train.seq_len)
            self._state, met = self._rnd(self._state, self._mesh_batch(raw),
                                         r)
            record(met, r)
            if ce and r % ce == 0 and r > 0:
                self.save(f"ckpt_round{r}")
        return self.history

    def save(self, path: str):
        """Checkpoint the state in the JAX trainer's layout
        (``convert.state_to_jax``): ``repro.checkpoint.load_pytree`` reads
        it into a JAX trainer's state, and this package's ``load_pytree``
        reads a JAX trainer's checkpoint. With ``fed.ef_store`` the
        ``errors`` leaf is the (n, d) cohort block of the last round, as
        the JAX trainer writes it. On the mesh every rank calls it: the
        per-rank EF rows and state shards are gathered into the global
        ``FedMeshState`` (``convert.mesh_state_to_jax``'s layout, the JAX
        mesh trainer's) and rank 0 writes it."""
        meta = {"round": len(self.history), "algo": self.fed.algorithm}
        if self.mesh is not None:
            full = meshmod.gather_fed_state(self._state, self.model,
                                            self.fed, self._ctx)
            if dist.get_rank() == 0:
                save_pytree(path, mesh_state_to_jax(full), meta)
            dist.barrier()
            return
        save_pytree(path, state_to_jax(self._state, self._sim.unravel),
                    meta)
