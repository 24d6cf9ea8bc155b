"""Quickstart on the PyTorch port: the same FedCAMS run as quickstart.py —
compressed client->server communication with error feedback, the FedAMS
max-stabilized server optimizer, and partial participation — through
``repro_torch`` on the card (or the CPU with ``--device cpu``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import FedConfig  # noqa: E402
from repro_torch.core import FedSim, sample_clients  # noqa: E402
from repro_torch.data import FederatedClassification  # noqa: E402
from repro_torch.models.convmixer import MLPConfig, mlp_defs, mlp_loss  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--rounds", type=int, default=50)
args = ap.parse_args()

mc = MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
data = FederatedClassification(num_clients=100, feature_dim=32, alpha=0.3)
fed = FedConfig(algorithm="fedcams", compressor="topk", compress_ratio=1 / 64,
                num_clients=100, participating=10, local_steps=3,
                eta=0.03, eta_l=0.05)

sim = FedSim(lambda p, b: mlp_loss(p, b, mc), fed, device=args.device)
state = sim.init(init_params(mlp_defs(mc), torch.Generator().manual_seed(0)))
gen = torch.Generator().manual_seed(1)

last = args.rounds - 1
for r in range(args.rounds):
    clients = sample_clients(gen, 100, 10).numpy()
    batches = data.round_batches(clients, r, fed.local_steps, 20)
    state, met = sim.round(state, batches, clients)
    if r % 10 == 0 or r == last:
        print(f"round {r:3d}  loss {float(met['loss']):.4f}  "
              f"communicated {float(met['bits'])/8e6:.2f} MB "
              f"(uncompressed would be "
              f"{float(state.round)*10*4*state.errors.shape[1]/1e6:.1f} MB)")
