"""Round stages of the simulation backend: the dense EF→compress→wire
uplink, the select-once sparse uplink, the server aggregates (plain and
survivor-masked), the two-way downlink and the γ diagnostic.

Counterpart of the simulation-side half of ``repro.core.stages``. The
mesh-side stages are not ported yet. The uplinks work on the resident
(m, d) EF buffer in place (the JAX stages return new error rows that the
round scatters back).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.compressors import Compressor, Selection
from repro_torch.core.error_feedback import ef_compress_rows
from repro_torch.kernels import ops, ref


def stage(name: str):
    """A ``torch.profiler`` range over one stage of a round, named
    ``fedsim.<name>``; a profiled round reports its host and device time per
    stage (``scripts/profile_round.py``; ranges nest, and a kernel counts
    for the innermost one). Nearly free when no profiler runs."""
    return torch.profiler.record_function(f"fedsim.{name}")


def _wire_roundtrip(codec, d: int, tot):
    """What the server decodes from each row of ``tot`` sent through
    ``codec``: the (c, nbytes) block of every client's message, encoded in
    one pass over the block and decoded in one."""
    with stage("encode"):
        bufs = codec.encode_rows(tot)
    with stage("decode"):
        return codec.decode_rows(bufs, d)


def client_uplink(comp: Optional[Compressor], codec, d: int, delta, errors,
                  rows):
    """Local delta → what the server receives, for a block of clients.

    ``delta``: (c, d) flat deltas; ``errors``: the (m, d) EF buffer, whose
    rows ``rows`` ((c,) int64, distinct) are updated IN PLACE — untouched
    when ``comp`` is None. Returns the (c, d) hats. Four cases, as in
    ``repro.core.stages.client_uplink``:

    * comp + codec — wire mode: the EF totals really go through
      encode→decode, all c clients' messages as one block; EF tracks the
      *decoded* value;
    * comp only — in-memory EF compression (``ef_compress_rows``: the
      ``sign_ef``/``topk_ef`` kernels for sign and blocktopk);
    * codec only — an uncompressed algorithm over a dense32 wire;
    * neither — the delta passes through untouched.
    """
    if comp is not None:
        if codec is None:
            return ef_compress_rows(comp, delta, errors, rows)
        tot = errors[rows] + delta
        hat = _wire_roundtrip(codec, d, tot)
        errors[rows] = tot - hat
        return hat
    if codec is not None:
        return _wire_roundtrip(codec, d, delta)
    return delta


def client_uplink_sparse(comp: Compressor, errors, rows, delta, block: int,
                         codec=None):
    """The select-once uplink for a block of clients, on the resident EF
    buffer.

    ``errors``: (m, d) fp32 EF buffer, updated IN PLACE; ``rows``: (c,)
    int64 distinct client rows; ``delta``: (c, d) local deltas; ``block``:
    the selection block (``block_layout(d, wire_block)[0]``). The EF totals
    ``errors[rows] + delta`` are selected once and their rows keep the
    residual (the totals with the picks zeroed) — in JAX terms
    ``errors.at[rows].add(delta)``, ``client_uplink_sparse`` and
    ``ef_update_sparse``.

    blocktopk runs the ``topk_ef_sparse`` kernel (its twin on the CPU),
    which leaves the float32-wire residual (the picks zeroed); global top-k
    runs ``comp.select`` per client. With a ``codec`` whose values narrow
    (fp16/bf16/int8), the server receives ``codec.roundtrip_selection`` of
    each selection — bit-identical to decoding the packed bytes — and the
    picks keep the quantization residual ``sel − rx``. Returns
    ``(rx_vals, idx)``, each (c, k_total): the values as the server
    receives them, blocks in order, global flat positions (a blockwise
    selection may point into the padded tail)."""
    c, d = delta.shape
    if comp.name.startswith("blocktopk"):
        k = max(1, int(round(comp.ratio * block)))
        vals, idx = ops.topk_ef_sparse(delta, errors, rows, k=k, block=block)
        vals, idx = vals.reshape(c, -1), idx.reshape(c, -1)
        exact = True     # the kernel already zeroed the picks
    else:
        errors[rows] += delta
        sels = [comp.select(t) for t in errors[rows]]
        vals = torch.stack([s.vals for s in sels])
        idx = torch.stack([s.idx for s in sels])
        exact = False
    if codec is None or codec.exact:
        if not exact:
            ef_update_sparse(errors, rows, idx, vals, vals)
        return vals, idx
    rx = torch.stack([codec.roundtrip_selection(Selection(v, i), d).vals
                      for v, i in zip(vals, idx)])
    ef_update_sparse(errors, rows, idx, vals, rx)
    return rx, idx


def ef_update_sparse(errors, rows, idx, sel_vals, rx_vals):
    """Finish sparse-path error feedback in place on the (m, d) buffer:
    the selected coordinates become ``sel_vals − rx_vals`` (exact zeros on
    a float32 wire). ``rows``: (c,); ``idx``/``sel_vals``/``rx_vals``:
    (c, k). Padded-block positions (``idx >= d``) are dropped."""
    d = errors.shape[1]
    r = rows[:, None].expand(idx.shape)
    keep = idx < d
    errors[r[keep], idx[keep].long()] = (sel_vals - rx_vals)[keep]


def server_aggregate_sparse(vals, idx, d: int, n: int):
    """Mean of n sparse client messages as a scatter-add over the (n·k)
    received entries, client by client (``ref.scatter_mean_padded``: no
    atomics race, collisions add in client order). Out-of-range padded
    indices land in a dead slot past d and are dropped."""
    safe = torch.where(idx < d, idx, d)
    return ref.scatter_mean_padded(vals, safe, d + 1, n)[:d]


def server_aggregate_sparse_masked(vals, idx, d: int, surv):
    """Survivor-masked sibling of :func:`server_aggregate_sparse`: the mean
    of the sparse client messages over the SURVIVORS only — ``surv`` (n,)
    f32 is a fault round's survivor mask (delivered and validated).
    Non-survivors' entries become 0 by ``where`` (never a multiply: a
    poisoned NaN times 0.0 is still NaN) and the divisor is the 0-d tensor
    ``max(Σsurv, 1)``, so an all-dead round yields a zero aggregate, not a
    NaN. Client-major, as ``ref.scatter_mean_padded``; indices outside
    ``[0, d)`` (a padded tail, ``INVALID_IDX``, a flipped index) land in
    the dead slot past d. With an all-ones mask this is bitwise
    :func:`server_aggregate_sparse`."""
    contrib = torch.where(surv[:, None] > 0, vals, 0.0)
    safe = torch.where((idx >= 0) & (idx < d), idx, d)
    acc = torch.zeros(d + 1, dtype=torch.float32, device=vals.device)
    for j in range(vals.shape[0]):
        acc.index_add_(0, safe[j].long(), contrib[j])
    return (acc / surv.sum().clamp_min(1.0))[:d]


def server_downlink(fed: FedConfig, comp: Optional[Compressor], codec,
                    new_flat, x_client, server_error):
    """Two-way (server→client) EF compression, paper appendix D.

    Returns ``(new_x_client, new_server_error)``: the model as clients will
    see it next round plus the carried server-side error. With ``two_way``
    off the clients see the exact new model and the error passes through.
    With it on, the server compresses ``(new − x_client) + error``: in wire
    mode as ``decode(encode(tot))`` through ``codec`` (the batched codec on
    a (1, d) block — on the card one ``pack_uint`` and one ``unpack_uint``
    launch for the packed codecs), else with ``comp.compress``."""
    if not (fed.two_way and comp is not None):
        return new_flat, server_error
    tot = (new_flat - x_client) + server_error
    if codec is not None:
        hat = _wire_roundtrip(codec, tot.numel(), tot[None])[0]
    else:
        hat = comp.compress(tot)
    return x_client + hat, tot - hat


def gamma_diagnostic(comp: Optional[Compressor], mean_tot, agg, mean_delta):
    """Assumption 4.17 diagnostic (paper Fig. 6):
    γ = ‖C(mean(Δ+e)) − mean(C(Δ+e))‖ / ‖mean(Δ)‖ — zero when
    uncompressed."""
    if comp is None:
        return torch.zeros((), dtype=torch.float32, device=agg.device)
    c_of_mean = comp.compress(mean_tot)
    return (torch.linalg.vector_norm(c_of_mean - agg)
            / torch.linalg.vector_norm(mean_delta).clamp_min(1e-12))


def resolve_fused_ingest(fed: FedConfig, *, eligible: bool,
                         have_kernel: bool, compiled: bool,
                         detail: str = "") -> str:
    """``fed.fused_ingest`` → the ingest path that will run: ``"kernel"``
    (``kernels.ops.fedams_ingest``), ``"jnp"`` (the plain blocked path) or
    ``"off"`` (two-pass ``server_aggregate_sparse`` + ``server_update``).

    The JAX package's rule: a forced knob the round cannot honor raises
    instead of silently falling back, and ``auto`` fuses whenever eligible,
    picking the kernel only where it compiles (here: on CUDA)."""
    knob = fed.fused_ingest
    if knob == "off":
        return "off"
    if not eligible:
        if knob in ("kernel", "jnp"):
            raise ValueError(
                f"FedConfig.fused_ingest={knob!r} but this round cannot "
                f"fuse the server ingest: {detail}")
        return "off"
    if knob == "kernel" and not have_kernel:
        raise ValueError(
            "FedConfig.fused_ingest='kernel' but no kernel is available")
    if knob in ("kernel", "jnp"):
        return knob
    return "kernel" if (have_kernel and compiled) else "jnp"
