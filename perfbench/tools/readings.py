"""The readings a cell's limits are set from, at the cell's own size, in
one process: for each seed the program's numbers against the reference
(the lower readings), the control's (the reference in the precision below
the configuration's, in the program's place) and, on the first
``--fault-seeds`` seeds, the program's with half of each batch left out
(its loss the mean over the rest). Every number of
``perfbench/reference/compare.py`` is read on every side, the compared and
the others, with the leaves where the worst gaps lie. A state left
unchanged reads 1 on the change's and the error rows' gaps by their
definition and needs no run.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1 2 3 \
        [--fault-seeds 3] [--out readings.jsonl]

Each reading is a JSON line on standard output (and in ``--out``). No
window is measured: the numbers come from set-up's rounds, as in a run.
"""
import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def half_batch(cell):
    """The program's loss over the first half of each batch alone: the
    port's ConvMixer loss (``fedsim_round``) or its language model's
    (``mesh_round``)."""
    halve = lambda b: {k: v[:v.shape[0] // 2] for k, v in b.items()}
    if cell.workload["driver"] == "mesh_round":
        from repro_torch.models.model import Model
        owner, name = Model, "loss"
        whole = Model.loss
        patched = lambda self, params, batch, *a, **k: whole(
            self, params, halve(batch), *a, **k)
    else:
        owner = importlib.import_module(
            f"perfbench.ports.{cell.config['family']}")
        name, whole = "loss_fn", owner.loss_fn

        def patched(model):
            base = whole(model)
            return lambda p, b: base(p, halve(b))
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, whole)


def client_flips(drv) -> int:
    """How many of the first round's blockwise top-k picks, client by
    client, the program and the reference made differently: positions
    that one side's error row zeroed (sent) and the other's kept. The
    program's rows are read after its first round (``first_rows``)."""
    from perfbench.reference.fedcams import FedCAMS
    from perfbench.reference.precision import full_float32
    full_float32()
    ids, batches = drv.pool[0]
    run = FedCAMS(drv.x0, drv.fed)
    run.round(ids, batches, lambda flat, b: drv.ref_model.loss_and_grad(
        flat, b, drv.model))
    flips = 0
    for i, c in enumerate(ids):
        mine = drv.first_rows[i] == 0
        theirs = run.errors[int(c)].cpu() == 0
        flips += int((mine != theirs).sum())
    return flips


def where(drv, mine: dict) -> dict:
    """The leaves (and error row) where ``mine``'s worst gaps against the
    reference lie, by name."""
    from perfbench.reference.compare import worst_leaves
    w = worst_leaves(mine, drv._ref)
    name = lambda i: "/".join(drv.layout[i][0])
    return {"grad_worst_leaf": name(w["grad_worst_leaf"]),
            "change_worst_leaf": name(w["change_worst_leaf"]),
            "ef_worst": f"row {w['ef_worst_row']} "
                        f"{name(w['ef_worst_leaf'])}"}


def diagnosis(drv) -> dict:
    """Where the program departs from the reference: the worst leaves and
    the first round's flipped picks."""
    w = where(drv, drv.mine)
    w["first_round_flipped_picks"] = client_flips(drv)
    return w


@contextlib.contextmanager
def first_rows():
    """Records the cohort's error rows after the first ``FedSim.round`` of
    each FedSim built inside, as ``<driver>.first_rows`` (set by the
    caller from the list this yields)."""
    from repro_torch.core.sim import FedSim
    whole = FedSim.round
    seen = []

    def round_(self, state, batches, ids, *a, **k):
        out = whole(self, state, batches, ids, *a, **k)
        if not getattr(self, "_first_rows_taken", False):
            self._first_rows_taken = True
            rows = torch.as_tensor(ids, device=out[0].errors.device)
            seen.append(out[0].errors[rows].cpu())
        return out

    FedSim.round = round_
    try:
        yield seen
    finally:
        FedSim.round = whole


def control_line(drv, seed: int) -> dict:
    """The control's numbers on ``seed``, and where its worst gaps lie."""
    from perfbench.reference.compare import training_gaps
    if drv._ref is None:
        drv.check()
    low = drv.control_readings()
    return {"seed": seed, "side": "control",
            "numbers": training_gaps(low, drv._ref), "where": where(drv, low)}


def readings(cell, seed: int, device, fault: bool) -> list:
    """One seed's readings: the program's, the control's and (``fault``)
    the half-batch fault's numbers, with the program's diagnosis."""
    drv_cls = importlib.import_module(
        f"perfbench.drivers.{cell.workload['driver']}").Driver
    t0 = time.perf_counter()
    sim = cell.workload["driver"] == "fedsim_round"
    with first_rows() as seen:
        drv = drv_cls(cell, seed, device)
    drv.release()
    out = [{"seed": seed, "side": "program", "numbers": drv.check()},
           control_line(drv, seed)]
    if sim:
        drv.first_rows = seen[0]
        out[0]["diagnosis"] = diagnosis(drv)
    if fault:
        with half_batch(cell):
            bad = drv_cls(cell, seed, device)
        bad.release()
        bad._ref = drv._ref
        out.append({"seed": seed, "side": "fault_half_batch",
                    "numbers": bad.check(), "where": where(bad, bad.mine)})
    out[0]["seconds"] = time.perf_counter() - t0
    return out


def readings_kept(cell, seeds: list, device, controls: int,
                  faults: int) -> list:
    """The same readings for a driver whose set-up is long and that can
    start again on another seed with the program it built (``start``):
    the program's rounds on every seed first, then, the program freed, the
    reference on each seed (and the control on the first ``controls``);
    then one driver with half of each batch left out, on the first
    ``faults`` seeds."""
    drv_cls = importlib.import_module(
        f"perfbench.drivers.{cell.workload['driver']}").Driver

    def snapshot(drv, seed):
        return {"seed": seed, "mine": drv.mine, "x0": drv.x0.cpu(),
                "pool": drv.pool}

    def runs(seeds):
        t0 = time.perf_counter()
        drv = drv_cls(cell, seeds[0], device)
        kept = [snapshot(drv, seeds[0])]
        for seed in seeds[1:]:
            drv.start(seed)
            kept.append(snapshot(drv, seed))
        drv.release()
        print(f"readings: {len(seeds)} seeds through the program in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return drv, kept

    out, refs = [], {}
    drv, kept = runs(seeds)
    for i, snap in enumerate(kept):
        t0 = time.perf_counter()
        drv.x0, drv.pool, drv.mine = (snap["x0"].to(device), snap["pool"],
                                      snap["mine"])
        drv._ref = None
        out.append({"seed": snap["seed"], "side": "program",
                    "numbers": drv.check(), "where": where(drv, drv.mine)})
        refs[snap["seed"]] = drv._ref
        if i < controls:
            out.append(control_line(drv, snap["seed"]))
        out[-1]["seconds"] = time.perf_counter() - t0
        yield from out
        out = []
    if faults:
        with half_batch(cell):
            bad, kept = runs(seeds[:faults])
        for snap in kept:
            bad.mine, bad._ref = snap["mine"], refs[snap["seed"]]
            yield {"seed": snap["seed"], "side": "fault_half_batch",
                   "numbers": bad.check(), "where": where(bad, bad.mine)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--control-seeds", type=int, default=0,
                    help="with a driver that starts again on another seed:"
                         " the seeds the control runs on (0: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    sink = open(args.out, "a") if args.out else None
    try:
        drv_cls = importlib.import_module(
            f"perfbench.drivers.{cell.workload['driver']}").Driver
        if hasattr(drv_cls, "start"):
            lines = readings_kept(cell, args.seeds, device,
                                  args.control_seeds or len(args.seeds),
                                  args.fault_seeds)
        else:
            lines = (line for i, seed in enumerate(args.seeds)
                     for line in readings(cell, seed, device,
                                          i < args.fault_seeds))
        for line in lines:
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
