"""Driver ``mesh_round``: a language model's federated round through the
port's ``launch/steps.py::build_train_step``, whose train
step (``launch/programs.py::TrainStep``) runs the mesh's per-round program
(``core/mesh.py::MeshRounds.round``), as ``launch/train.py`` runs it.

Set-up starts a one-rank process group (NCCL on the card, gloo on the
CPU) on a (1, 1) ("data", "model") mesh, builds the step from the
configuration (``arch``, and the widths and depth of ``model``) and the
traffic mix (``fed``: ``FedConfig``'s fields; ``train``:
``TrainConfig``'s), makes the weights on the device from the seed, pre-draws
the mix's pool of global batches, then drives the step through its first
``check_rounds`` rounds through the window's own call: the first call
builds, warms up and captures the round's program. What they leave (their
losses, the server's momentum after the first, the parameters and the
client's error row after the last) is what the comparison reads; the
step consumes each state, so the readings are taken as the rounds go.

A window call stages the pool's next global batch onto the device
(``core/mesh.py::shard_batch``) and runs one round.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import socket

import torch

from perfbench.counts.kernels import bytes_per_round
from perfbench.drivers.common import Clock, make_weights, nested
from perfbench.reference import fedcams as ref_fedcams
from perfbench.reference.compare import training_gaps
from perfbench.reference.precision import full_float32
from perfbench.traffic.generator import mesh_rounds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_config(config: dict):
    """The program's ``ModelConfig``: the architecture's published one
    with the configuration's widths, depth and compute precision."""
    from repro_torch.configs.registry import get_arch
    m = config["model"]
    base = get_arch(config["arch"]).model
    return dataclasses.replace(
        base, num_layers=m["num_layers"], d_model=m["d_model"],
        num_heads=m["num_heads"], num_kv_heads=m["num_heads"], head_dim=0,
        vocab_size=m["vocab_size"], block_pattern=tuple(m["block_pattern"]),
        dtype=config["compute_dtype"],
        xlstm=dataclasses.replace(
            base.xlstm, pattern=tuple(m["block_pattern"]),
            mlstm_proj_factor=m["mlstm_proj_factor"],
            slstm_proj_factor=m["slstm_proj_factor"]))


class Driver:
    def __init__(self, cell, seed: int, device):
        import torch.distributed as dist
        from repro_torch.configs.base import (FedConfig, ShapeConfig,
                                              TrainConfig)
        from repro_torch.configs.registry import get_arch
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_mesh

        clock = Clock()
        tr = cell.traffic
        self.family = cell.config["family"]
        self.model = cell.config["model"]
        self.ref_model = importlib.import_module(
            f"perfbench.reference.{self.family}")
        self.reference_rows = cell.config["reference_rows"]
        self.layout = self.ref_model.layout(self.model)
        self.sizes = ref_fedcams.leaf_sizes(self.layout)
        self.fed = dict(tr["fed"])
        ref_fedcams.check_modelled(self.fed)
        self.check_rounds = cell.workload["check_rounds"]
        self.batch, self.seq = tr["batch"], tr["seq_len"]
        self.device = device
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                world_size=1)
        mesh = make_mesh((1, 1), ("data", "model"), device.type)
        spec = dataclasses.replace(get_arch(cell.config["arch"]),
                                   model=port_config(cell.config))
        b = steps.build_train_step(
            spec, ShapeConfig(cell.name, self.seq, self.batch, "train"), mesh,
            FedConfig(**self.fed), TrainConfig(**tr["train"]))
        self.bundle = b
        self.train = dataclasses.replace(TrainConfig(**tr["train"]),
                                         global_batch=self.batch,
                                         seq_len=self.seq)
        clock.lap("imports and the step")
        self.traffic = tr
        self.start(seed, clock)
        #: seconds of each part of set-up after the process's imports
        self.setup_parts = clock.parts

    def start(self, seed: int, clock=None) -> None:
        """From ``seed``: the pool, the weights, a fresh state, and the
        first rounds through the step (whose program, once built, is kept:
        the readings tool starts one driver on many seeds)."""
        from repro_torch.core.mesh import FedMeshState
        from repro_torch.models.params import tree_map
        clock = clock or Clock()
        tr, device = self.traffic, self.device
        self.pool = mesh_rounds(tr, seed, tr["pool_rounds"],
                                self.bundle.fed.num_clients)
        if len(self.pool) <= self.check_rounds:
            raise ValueError("the pool must hold more rounds than the "
                             f"{self.check_rounds} set-up drives")
        clock.lap("traffic pool")
        self.x0 = make_weights(self.layout, seed, device)
        zeros = lambda: nested(self.layout, torch.zeros_like(self.x0))
        state = FedMeshState(
            params=nested(self.layout, self.x0.clone()), m=zeros(),
            v=zeros(), vhat=zeros(),
            # one client's error rows: a leading client dim of 1
            errors=tree_map(lambda t: t[None], zeros()),
            round=torch.zeros((), dtype=torch.int32, device=device))
        clock.lap("weights and state")
        losses, b1 = [], self.fed["beta1"]
        for r in range(self.check_rounds):
            state, met = self.bundle.fn(state, self._batch(r), r)
            losses.append(float(met["loss"]))
            clock.lap(f"round {r}")
            if r == 0:
                grad = ref_fedcams.leaf_norms(
                    self._flat(state.m) / (1 - b1), self.sizes).cpu()
        self.mine = {"losses": losses, "grad_norms": grad,
                     "change_norms": ref_fedcams.leaf_norms(
                         self._flat(state.params) - self.x0,
                         self.sizes).cpu(),
                     "ef_norms": self._leaf_norms(state.errors)[None]}
        self.state, self.r = state, self.check_rounds
        self._ref = None

    def _flat(self, tree) -> torch.Tensor:
        """A state tree's leaves, in the layout's order, as one vector."""
        from repro_torch.models.params import tree_leaves
        return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])

    @staticmethod
    def _leaf_norms(tree) -> torch.Tensor:
        """Each leaf's norm, in the layout's order, leaf by leaf (no flat
        copy of the tree)."""
        from repro_torch.models.params import tree_leaves
        return torch.stack([torch.linalg.vector_norm(t.double()).cpu()
                            for t in tree_leaves(tree)])

    def _batch(self, r: int):
        from repro_torch.core.mesh import shard_batch
        b = self.bundle
        return shard_batch(self.pool[r % len(self.pool)], b.model, b.fed,
                           self.train, b.ctx, self.device)

    def call(self):
        """One round: the window's timed call."""
        self.state, met = self.bundle.fn(self.state, self._batch(self.r),
                                         self.r)
        self.r += 1
        return met

    @staticmethod
    def read(met) -> bool:
        """The host read of a round's metrics; false if the loss is not
        finite (the round failed)."""
        values = {k: float(v) for k, v in met.items()}
        return math.isfinite(values["loss"])

    def flops_per_round(self):
        """The model FLOPs of one round's local training
        (``perfbench/counts/<family>.py``)."""
        counts = importlib.import_module(f"perfbench.counts.{self.family}")
        return (self.fed["local_steps"] * self.batch
                * counts.train_flops_per_sequence(self.model, self.seq))

    def kernel_bytes_per_round(self) -> dict:
        """The bytes each of the port's uplink and server kernels must move
        in a round, by its device function: one launch a leaf."""
        return bytes_per_round(self.sizes)

    def release(self) -> None:
        """Frees the program and its state, and ends the process group:
        the reference runs after."""
        import repro_torch
        import torch.distributed as dist
        self.state = self.bundle = None
        repro_torch.clear_caches()
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if dist.is_initialized():
            dist.destroy_process_group()

    def reference(self, f8: bool = False) -> dict:
        """The reference's readings of the first rounds, from the same
        weights and batches (float8 operands: the control)."""
        full_float32()
        lg = lambda flat, batch: self.ref_model.loss_and_grad(
            flat, batch, self.model, f8, self.reference_rows)
        plan = [(torch.zeros(1, dtype=torch.int64),
                 {k: v[None] for k, v in raw.items()})
                for raw in self.pool[:self.check_rounds]]
        return ref_fedcams.rounds(self.x0, self.fed, plan, lg, self.sizes,
                                  segments=self.sizes)

    def check(self) -> dict:
        """The numbers compared: the program's readings against the
        float32 reference's."""
        if self._ref is None:
            self._ref = self.reference()
        return training_gaps(self.mine, self._ref)

    def control_readings(self) -> dict:
        """The float8 reference's readings, the control's."""
        return self.reference(f8=True)

    def control(self) -> dict:
        """The numbers compared with the float8 reference in the program's
        place."""
        if self._ref is None:
            self._ref = self.reference()
        return training_gaps(self.control_readings(), self._ref)
