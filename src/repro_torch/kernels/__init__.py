"""Hand-written CUDA kernels for the FedCAMS round (``csrc/``), their plain
PyTorch twins (``ref``), and the per-call dispatch (``ops``).

Ported from the Pallas TPU kernels of ``repro.kernels``:
``topk_ef_sparse`` (client selection + error feedback), ``fedams_ingest``
(fused server ingest) and ``fedams_update`` (two-pass server step)."""
