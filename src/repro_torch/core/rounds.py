"""Re-export façade over the layered round engine (counterpart of
``repro.core.rounds``), limited to the names the port has:

* ``core/local.py``  — local-update rules, the per-round local LR
  schedule, heterogeneous per-client step counts;
* ``core/stages.py`` — the simulation-side EF→compress→wire stages, the
  server aggregates (plain, grouped, masked, weighted) and the two-way
  downlink;
* ``core/sim.py``    — ``FedSim``, the simulation backend.

The mesh backend's names (``build_fed_round`` and the mesh strategies) wait
for the port's mesh. New code should import from the layer modules.
"""
from repro_torch.core.local import (LocalUpdate,  # noqa: F401
                                    hetero_step_counts, local_lr,
                                    make_local_update, run_local_steps)
from repro_torch.core.sim import FedSim, SimState  # noqa: F401
from repro_torch.core.stages import (client_uplink,  # noqa: F401
                                     client_uplink_sparse, gamma_diagnostic,
                                     server_aggregate_sparse,
                                     server_aggregate_sparse_grouped,
                                     server_aggregate_sparse_masked,
                                     server_aggregate_sparse_weighted,
                                     server_downlink)
