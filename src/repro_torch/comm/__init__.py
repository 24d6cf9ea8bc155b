"""Wire formats, transport and faults for FedCAMS messages (counterpart of
``repro.comm``): ``wire`` (packed byte codecs), ``transport`` (the
simulated network), ``metrics`` (``CommLog``) and ``faults`` (the fault
model, its planner and the server's validation before ingest)."""
from repro_torch.comm.faults import (FAULT_CORRUPT_MODES,  # noqa: F401
                                     FaultConfig, FaultInjector, FaultPlan)
from repro_torch.comm.metrics import CommLog  # noqa: F401
from repro_torch.comm.transport import (NetworkConfig,  # noqa: F401
                                        RoundTiming, SimulatedNetwork)
from repro_torch.comm.wire import (HEADER_BYTES, WireCodec,  # noqa: F401
                                   make_blocktopk_codec, make_dense32_codec,
                                   make_sign_codec, make_topk_codec,
                                   make_wire_codec, measured_vs_analytic,
                                   parse_header)
