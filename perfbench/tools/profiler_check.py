"""Does the profiler see the kernels of a replayed CUDA graph? Builds a
cell's driver on the card, reads the round program's graph from the
driver (its nodes by type, ``cuGraphGetNodes`` / ``cuGraphNodeGetType``),
profiles ``--rounds`` rounds as a traced run does and compares the kernel
records with the graph's kernel nodes times the replays.

    python3 perfbench/tools/profiler_check.py --workload <cell> --rounds 5

Prints one JSON line. The driver must keep its program's graph
(``FedSim``'s programs keep theirs).
"""
import argparse
import ctypes
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: CUgraphNodeType values (the driver's cuda.h) by name
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              10: "mem_alloc", 11: "mem_free"}


def node_types(graph) -> dict:
    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    kind, out = ctypes.c_int(0), {}
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        name = NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    drv = importlib.import_module(
        f"perfbench.drivers.{cell.workload['driver']}").Driver(
            cell, args.seed, device)
    graphs = [p.graph for p in drv.sim._programs.values()]
    nodes = node_types(graphs[0])
    dev, _, ranges = harness.profile(drv, args.rounds, device)
    kinds = {"kernel": 0, "memcpy": 0, "memset": 0}
    names = {}
    for name, _, _ in dev:
        low = name.lower()
        kind = ("memset" if "memset" in low else
                "memcpy" if "memcpy" in low else "kernel")
        kinds[kind] += 1
        if kind != "kernel":
            names[name] = names.get(name, 0) + 1
    print(json.dumps({
        "programs": len(graphs), "graph_nodes": nodes,
        "rounds_profiled": len(ranges), "records": kinds,
        "records_all": len(dev),
        "graph_nodes_times_replays": sum(nodes.values()) * len(ranges),
        "kernel_nodes_times_replays": nodes.get("kernel", 0) * len(ranges),
        "copy_and_set_names": names,
        "torch": torch.__version__, "cuda": torch.version.cuda}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
