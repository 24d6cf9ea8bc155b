"""Wire-mode quickstart on the PyTorch port: the same run as
quickstart_wire.py — every client delta serialized to packed bytes
(``repro_torch.comm.wire``), pushed through a simulated heterogeneous
network (``repro_torch.comm.transport``) and decoded server-side, with a
two-way-compressed downlink — driven by ``repro_torch``'s
``FederatedTrainer`` on the card (or the CPU with ``--device cpu``).

    PYTHONPATH=src python examples/quickstart_wire_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.comm import NetworkConfig, SimulatedNetwork  # noqa: E402
from repro_torch.configs import FedConfig, TrainConfig  # noqa: E402
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.data import FederatedClassification  # noqa: E402
from repro_torch.models.convmixer import MLPConfig, mlp_defs, mlp_loss  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--rounds", type=int, default=50)
args = ap.parse_args()

mc = MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
fed = FedConfig(algorithm="fedcams", compressor="sign",
                num_clients=100, participating=10, local_steps=3,
                eta=0.1, eta_l=0.05, eps=1e-4,   # benchmarks/common.py TUNED
                wire=True, two_way=True)      # <- measured bytes, both ways
net = SimulatedNetwork(                        # uplink-constrained WAN with
    NetworkConfig(uplink_mbps=10, downlink_mbps=50,  # 5% stragglers
                  straggler_prob=0.05, seed=0), fed.num_clients)

trainer = FederatedTrainer(
    fed=fed, train=TrainConfig(rounds=args.rounds, log_every=10),
    loss_fn=lambda p, b: mlp_loss(p, b, mc),
    init_params=init_params(mlp_defs(mc), torch.Generator().manual_seed(0)),
    network=net, device=args.device)
trainer.data = FederatedClassification(num_clients=100, feature_dim=32,
                                       alpha=0.3)

hist = trainer.run(log=None)
for rec in hist:
    if rec["round"] % 10 == 0 or rec["round"] == len(hist) - 1:
        print(f"round {rec['round']:3d}  loss {rec['loss']:.4f}  "
              f"wire {rec['wire_bytes']/1e6:6.2f} MB  "
              f"round {rec['round_time_s']*1e3:6.1f} ms  "
              f"simulated total {rec['sim_time_s']:6.2f} s")
d = trainer._sim._d
print(f"\nuncompressed fp32 would be {len(hist)*10*2*4*d/1e6:.1f} MB; "
      f"the wire carried {hist[-1]['wire_bytes']/1e6:.2f} MB")
