"""The port's benchmark: one run of one cell on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout; ``<cell>`` names
``perfbench/workloads/<cell>.json``. The run makes its weights and traffic
from ``--seed``, warms up and checks in set-up, measures for ``--seconds``
seconds, with ``--trace 1`` profiles a few more rounds, then compares what
the timed path produced against the plain reference. Its last line on
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared with its limit, which also close
standard error. It exits with 1 and prints no result when the card is
missing or the cell asks for more cards than there are, or when JAX or
the JAX package was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 1
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         started=STARTED)
    print(f"perfbench: {harness.card_line()}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
