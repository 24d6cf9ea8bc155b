"""Hand-written CUDA kernels for the FedCAMS round (``csrc/``), their plain
PyTorch twins (``ref``), and the per-call dispatch (``ops``).

Ported from the Pallas TPU kernels of ``repro.kernels``, all of them:
``topk_ef_sparse`` (client selection + error feedback), ``topk_ef`` (the
same with a dense hat), ``sign_ef`` (scaled sign + error feedback),
``pack_uint``/``unpack_uint`` (the wire's n-bit streams),
``fedams_ingest`` (fused server ingest) and ``fedams_update`` (two-pass
server step)."""
