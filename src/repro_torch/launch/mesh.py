"""Mesh construction.

Counterpart of ``repro.launch.mesh.make_mesh``: a ``DeviceMesh`` with one
named dim per JAX mesh axis (``init_device_mesh``). It needs the process
group first: every rank calls ``torch.distributed.init_process_group``
(its address, world size and rank given explicitly — nothing on the
machine announces a cluster), then ``make_mesh`` with the same arguments.
The mesh's size must equal the world size; ranks are laid out row-major
over ``shape``, as ``jax.make_mesh`` lays out devices.

:func:`spawn` starts the ranks of the LM drivers (``launch/train.py``,
``launch/serve.py`` at tp > 1): gloo on the CPU; on CUDA, NCCL when every
rank has a card of its own, else gloo with the ranks sharing the cards
(NCCL refuses two ranks on one card).

:class:`BackendSpec` holds one card's roofline constants (the
reference's per-chip table, here the H100's: its TPU rows are not carried
over); :func:`backend_spec` resolves one by name or ``REPRO_BACKEND``.
:func:`make_production_mesh` is the reference's production layout over the
initialized process group, and :func:`start_fake_world` initializes the
``fake`` backend at rank 0 of a world of any size, so the dry run
(``launch/dryrun.py``) builds rank 0's program of a 256- or 512-card mesh
in one process, with no card — the counterpart of the reference's
``--xla_force_host_platform_device_count=512``.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Per-card roofline constants for one accelerator backend."""
    name: str
    peak_flops_bf16: float     # FLOP/s
    hbm_bw: float              # B/s
    ici_bw_per_link: float     # B/s per link


#: Known backends, per card. ``h100_sxm``: NVIDIA's data sheet for the SXM
#: part at 700 W, dense bf16, HBM3, NVLink at 450 GB/s each way.
BACKEND_SPECS = {
    "h100_sxm": BackendSpec("h100_sxm", peak_flops_bf16=989e12,
                            hbm_bw=3.35e12, ici_bw_per_link=450e9),
}

DEFAULT_BACKEND = "h100_sxm"


def backend_spec(name: str | None = None) -> BackendSpec:
    """Resolve a :class:`BackendSpec` by name; ``None`` reads the
    ``REPRO_BACKEND`` env var and falls back to ``h100_sxm``."""
    name = name or os.environ.get("REPRO_BACKEND") or DEFAULT_BACKEND
    try:
        return BACKEND_SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}: pick one of "
            f"{sorted(BACKEND_SPECS)} (or extend BACKEND_SPECS)") from None


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh over the initialized process group: (16, 16)
    over ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")``; the world size must be 256 or 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def start_fake_world(world: int) -> None:
    """Initialize the ``fake`` process group as rank 0 of ``world`` ranks:
    every collective returns at once and moves nothing, so one process
    builds rank 0's program of any mesh. Raises when this torch has no
    fake backend (``torch.testing._internal.distributed.fake_pg``); it
    never falls back to another backend."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "repro_torch: this torch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg), which the dry "
            "run needs to build a mesh of many ranks in one process") from e
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape, axes, device="cuda"):
    """Arbitrary mesh over the initialized process group; ``device`` is
    where the ranks' tensors live (``"cuda"`` or ``"cpu"``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, backend, cards, outdir, fn, args, kw):
    """One spawned rank: its card (rank modulo the cards), the process
    group, ``fn(*args, device=..., **kw)``; rank 0 writes its result to
    ``outdir``."""
    device = kw.pop("device")
    if device != "cpu":
        device = f"cuda:{rank % cards}"
        torch.cuda.set_device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = fn(*args, device=device, **kw)
        if rank == 0:
            torch.save(out, os.path.join(outdir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device="cuda", timeout: float = 3600,
          **kw):
    """``fn(*args, device=<this rank's device>, **kw)`` on ``world``
    spawned ranks (``torch.multiprocessing``, spawn; ``fn`` a module-level
    function), each with the process group initialized: gloo on the CPU
    (``device="cpu"``); on CUDA NCCL when every rank has a card of its
    own, else gloo with the ranks sharing the cards. Returns rank 0's
    result; a rank that fails, or outlives ``timeout`` seconds, raises
    (the others are stopped)."""
    import torch.multiprocessing as mp

    if device == "cpu":
        backend, cards = "gloo", 0
    else:
        cards = torch.cuda.device_count()
        if not cards:
            raise RuntimeError(
                "repro_torch: CUDA was requested but no card is present — "
                "pass --device cpu to run on the CPU")
        backend = "nccl" if world <= cards else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank, args=(world, _free_port(), backend, cards, tmp, fn, args,
                         dict(kw, device=device)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
