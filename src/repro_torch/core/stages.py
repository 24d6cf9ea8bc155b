"""Round stages of both backends.

Counterpart of ``repro.core.stages``:

* the simulation side — the dense EF→compress→wire uplink, the select-once
  sparse uplink, the server aggregates (plain, two-level grouped,
  survivor-masked and staleness-weighted), the two-way downlink and the γ
  diagnostic. The uplinks work on the resident (m, d) EF buffer in place
  (the JAX stages return new error rows that the round scatters back);
* the mesh side — this rank's leaf tensors and the client-axis
  collectives of ``sharding.rules.ParallelContext``: the dense psum, the
  compacted-Selection gather (flat, validated and two-level) and the
  packed-sign gather, dispatched by :func:`mesh_uplink`. The gathered
  selections are summed by :func:`scatter_add_clients`, one
  ``index_add_`` a client in client order, so the mesh's sparse aggregate
  is FedSim's to the bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.compressors import Compressor, Selection
from repro_torch.comm.faults import validate_selection
from repro_torch.core.compressors import randk_positions
from repro_torch.core.error_feedback import ef_compress_masked, ef_compress_rows
from repro_torch.kernels import ops, ref
from repro_torch.models.params import tree_map, tree_unzip


def stage(name: str, backend: str = "fedsim"):
    """A ``torch.profiler`` range over one stage of a round, named
    ``<backend>.<name>`` (``fedsim.`` for FedSim, ``mesh.`` for the mesh
    round); a profiled round reports its host and device time per stage
    (``scripts/profile_round.py``; ranges nest, and a kernel counts for the
    innermost one). Nearly free when no profiler runs."""
    return torch.profiler.record_function(f"{backend}.{name}")


def _wire_roundtrip(codec, d: int, tot):
    """What the server decodes from each row of ``tot`` sent through
    ``codec``: the (c, nbytes) block of every client's message, encoded in
    one pass over the block and decoded in one."""
    with stage("encode"):
        bufs = codec.encode_rows(tot)
    with stage("decode"):
        return codec.decode_rows(bufs, d)


def client_uplink(comp: Optional[Compressor], codec, d: int, delta, errors,
                  rows, draws=None):
    """Local delta → what the server receives, for a block of clients.

    ``delta``: (c, d) flat deltas; ``errors``: the (m, d) EF buffer, whose
    rows ``rows`` ((c,) int64, distinct) are updated IN PLACE — untouched
    when ``comp`` is None; ``draws``: randk's (c, k) drawn positions (the
    JAX stage's per-client keys), else None. Returns the (c, d) hats. Four
    cases, as in ``repro.core.stages.client_uplink``:

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
            return ef_compress_rows(comp, delta, errors, rows, draws)
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


def scatter_add_clients(acc, vals, idx):
    """Add n clients' ``(vals, idx)`` (n, k) into ``acc`` ((d + 1,) fp32, in
    place) client by client: one ``index_add_`` a client, whose indices are
    distinct, so collisions add in client order on any device and no float
    atomics race. Indices outside ``[0, d)`` (a padded tail,
    ``INVALID_IDX``, a flipped index) land in the dead slot ``acc[d]``."""
    d = acc.numel() - 1
    safe = torch.where((idx >= 0) & (idx < d), idx, d).long()
    for j in range(vals.shape[0]):
        acc.index_add_(0, safe[j].reshape(-1), vals[j].reshape(-1))
    return acc


def server_aggregate_sparse(vals, idx, d: int, n: int):
    """Mean of n sparse client messages as a scatter-add over the (n·k)
    received entries, client by client (:func:`scatter_add_clients`: no
    atomics race, collisions add in client order). Out-of-range padded
    indices land in a dead slot past d and are dropped."""
    acc = torch.zeros(d + 1, dtype=torch.float32, device=vals.device)
    return ref.div_rn(scatter_add_clients(acc, vals, idx), n)[:d]


def server_aggregate_sparse_grouped(vals, idx, d: int, n: int, groups: int):
    """Two-tier mean of n sparse client messages: the clients split into
    ``groups`` contiguous groups of n/g; each group scatters its members'
    entries client-major into a FRESH dense partial (tier 1), and the root
    sums the g partials in group order (tier 2), then divides by n.
    Against :func:`server_aggregate_sparse` only coordinates picked in two
    or more groups can reassociate, by at most 1 ulp each (the reference's
    own analysis)."""
    per = vals.shape[0] // groups
    total = None
    for g in range(groups):
        part = scatter_add_clients(
            torch.zeros(d + 1, dtype=torch.float32, device=vals.device),
            vals[g * per:(g + 1) * per], idx[g * per:(g + 1) * per])
        total = part if total is None else total + part
    return ref.div_rn(total, n)[:d]


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
    acc = scatter_add_clients(
        torch.zeros(d + 1, dtype=torch.float32, device=vals.device), contrib,
        idx)
    return (acc / surv.sum().clamp_min(1.0))[:d]


def server_aggregate_sparse_weighted(vals, idx, d: int, w):
    """Weighted sibling of :func:`server_aggregate_sparse_masked` for the
    async buffered flush: ``w`` (n,) f32 is each buffer entry's staleness
    weight × validity × fill, and the aggregate is ``Σ w_i·vals_i /
    max(Σw, 1)``. Zero-weight entries become 0 by ``where`` BEFORE the
    multiply (a rejected payload's NaN times 0.0 is still NaN); the divisor
    is a 0-d tensor. With all-ones ``w`` this is bitwise
    :func:`server_aggregate_sparse` (``vals * 1.0`` is exact and the scatter
    order is the same)."""
    contrib = torch.where(w[:, None] > 0, vals, 0.0) * w[:, None]
    acc = scatter_add_clients(
        torch.zeros(d + 1, dtype=torch.float32, device=vals.device), contrib,
        idx)
    return (acc / w.sum().clamp_min(1.0))[:d]


def server_downlink(fed: FedConfig, comp: Optional[Compressor], codec,
                    new_flat, x_client, server_error, draw=None):
    """Two-way (server→client) EF compression, paper appendix D.

    Returns ``(new_x_client, new_server_error)``: the model as clients will
    see it next round plus the carried server-side error. With ``two_way``
    off the clients see the exact new model and the error passes through.
    With it on, the server compresses ``(new − x_client) + error``: in wire
    mode as ``decode(encode(tot))`` through ``codec`` (the batched codec on
    a (1, d) block — on the card one ``pack_uint`` and one ``unpack_uint``
    launch for the packed codecs), else with ``comp.compress`` (``draw``:
    randk's drawn positions, else None)."""
    if not (fed.two_way and comp is not None):
        return new_flat, server_error
    tot = (new_flat - x_client) + server_error
    if codec is not None:
        hat = _wire_roundtrip(codec, tot.numel(), tot[None])[0]
    else:
        hat = comp.compress(tot, draw)
    return x_client + hat, tot - hat


def gamma_diagnostic(comp: Optional[Compressor], mean_tot, agg, mean_delta,
                     draw=None):
    """Assumption 4.17 diagnostic (paper Fig. 6):
    γ = ‖C(mean(Δ+e)) − mean(C(Δ+e))‖ / ‖mean(Δ)‖ — zero when
    uncompressed. ``draw``: randk's drawn positions for C, else None."""
    if comp is None:
        return torch.zeros((), dtype=torch.float32, device=agg.device)
    c_of_mean = comp.compress(mean_tot, draw)
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


# ===========================================================================
# Mesh-side stages (this rank's leaf tensors, client-axis collectives)
# ===========================================================================


def _div(a, n):
    """``a / n``, a true division, for a Python number or 0-d tensor n."""
    if isinstance(n, torch.Tensor):
        return a / n.to(a.device, a.dtype)
    return ref.div_rn(a, float(n))


def agg_dense(hat_tree, my_mask, n_eff, ctx, wire_dtype: str = "float32"):
    """Paper-faithful: dense psum over the client axes. ``wire_dtype``
    narrows the collective payload (bf16 halves client-axis bytes; the
    caller keeps error feedback exact by tracking the narrowed value)."""
    wd = getattr(torch, wire_dtype)

    def leaf(h):
        contrib = torch.where(my_mask > 0, h, 0.0).to(wd)
        return _div(ctx.psum_clients(contrib).float(), n_eff)

    return tree_map(leaf, hat_tree)


def mesh_agg_strategy(fed: FedConfig) -> str:
    """Which client-axis collective the mesh round actually runs for this
    config: ``"sparse_topk"`` (compacted Selection all_gather),
    ``"sparse_topk_hier"`` (two-level: member-axis Selection gather into a
    dense group partial, then the root consumes the g partials —
    ``agg_groups > 1``), ``"packed_sign"`` (1-bit packed gather), or
    ``"dense"`` (psum — including every fallback: non-fedcams algorithms,
    and sparse aggregation requested for a compressor with no compacted
    form). ``mesh_uplink`` and ``mesh_wire_bytes`` both resolve through
    here, so the wire accounting reports the path that executes."""
    if fed.algorithm != "fedcams" or fed.aggregation != "sparse":
        return "dense"
    if fed.compressor in ("topk", "blocktopk"):
        return "sparse_topk_hier" if fed.agg_groups > 1 else "sparse_topk"
    if fed.compressor == "packedsign":
        return "packed_sign"
    return "dense"


def resolve_mesh_sparse_impl(fed: FedConfig, kernel_impl) -> str:
    """``fed.mesh_sparse_impl`` → the selection provider that will run:
    ``"kernel"`` (``KernelImpl.topk_select_tree``: the ``topk_ef_sparse``
    kernel on CUDA tensors, its twin on the CPU) or ``"jnp"``
    (``Compressor.select``; the name is the JAX knob's). ``auto`` picks the
    kernel only when a KernelImpl is supplied and its tensors are on CUDA
    (``KernelImpl.compiled``), as the JAX rule picks it only where Pallas
    compiles."""
    impl = fed.mesh_sparse_impl
    if impl == "kernel":
        if kernel_impl is None:
            raise ValueError(
                "FedConfig.mesh_sparse_impl='kernel' but no kernel_impl "
                "was supplied — pass KernelImpl() to build_fed_round")
        return "kernel"
    if impl == "jnp":
        return "jnp"
    return ("kernel" if kernel_impl is not None and kernel_impl.compiled
            else "jnp")


def select_tree(select_leaf, delta, err, mask):
    """Shared select-once tree plumbing for both selection providers
    (:func:`topk_select_tree` and ``KernelImpl.topk_select_tree``).
    ``select_leaf(delta_leaf, err_leaf) -> (Selection, new_err_leaf)``;
    this wrapper applies the participation mask — a non-participating
    client (``mask == 0``) contributes zero values and keeps its error.
    Returns ``(sel_tree, err_tree)`` with
    :class:`~repro_torch.core.compressors.Selection` leaves (flat ``idx``
    in each leaf's zero-padded block domain)."""
    def leaf(dd, ee):
        sel, ne = select_leaf(dd, ee)
        return (Selection(vals=sel.vals * (mask > 0), idx=sel.idx),
                torch.where(mask > 0, ne, ee))

    return tree_unzip(tree_map(leaf, delta, err), 2)


def topk_select_tree(comp: Compressor, delta, err, mask):
    """Select-once uplink for every leaf of this rank's tree with
    ``comp.select`` (the plain path, bit-identical to the kernel
    provider): per leaf the EF total ``delta + err`` is selected once and
    its residual is the total with the picks zeroed; padded-tail indices
    (``idx >= d``) carry 0.0 and are dropped."""

    def leaf(dd, ee):
        tot = (dd + ee).reshape(-1)
        sel = comp.select(tot)
        keep = sel.idx < tot.numel()
        res = tot.clone()
        res[sel.idx[keep].long()] = 0.0
        return sel, res.reshape(ee.shape)

    return select_tree(leaf, delta, err, mask)


def mesh_select_tree(fed: FedConfig, comp: Compressor, kernel_impl, delta,
                     err, mask):
    """The select-once uplink of this rank's tree through the provider
    :func:`resolve_mesh_sparse_impl` picks: ``KernelImpl.topk_select_tree``
    or :func:`topk_select_tree`. Returns ``(sel_tree, err_tree)``."""
    if resolve_mesh_sparse_impl(fed, kernel_impl) == "kernel":
        return kernel_impl.topk_select_tree(comp.ratio, delta, err, mask)
    return topk_select_tree(comp, delta, err, mask)


def sparse_topk_leaf(sel: Selection, leaf, n_eff, ctx):
    """Aggregate one leaf from the clients' compacted Selections: the
    client-axis all_gather carries the ``(vals, idx)`` pairs and the
    server side is :func:`scatter_add_clients` over the gathered (m, nb·k)
    stack, client by client — :func:`server_aggregate_sparse` exactly.
    ``leaf`` supplies the output shape; padded-tail indices are dropped."""
    d = leaf.numel()
    g_vals = ctx.all_gather_clients(sel.vals[None], axis=0)
    g_idx = ctx.all_gather_clients(sel.idx[None], axis=0)
    acc = torch.zeros(d + 1, dtype=torch.float32, device=g_vals.device)
    return _div(scatter_add_clients(acc, g_vals, g_idx),
                n_eff)[:d].reshape(leaf.shape)


def sparse_topk_leaf_validated(sel: Selection, leaf, mask, ctx, domain: int,
                               max_norm: float):
    """Fault-tolerant sibling of :func:`sparse_topk_leaf`: the gathered
    ``(vals, idx)`` pass the server's validation-before-ingest gate
    (NaN/Inf, index range against the leaf's padded block ``domain``, the
    optional norm clip) and the scatter-mean runs over ``alive ∧ valid``
    (:func:`server_aggregate_sparse_masked`, as FedSim's fault round).
    ``mask``: (m,) f32 alive-mask on the leaf's device. Returns ``(agg,
    my_valid, rejected)``: the aggregated leaf, THIS rank's own validity
    (every rank sees the gathered copies, its own damaged payload
    included) and the count of delivered-but-rejected clients."""
    d = leaf.numel()
    g_vals = ctx.all_gather_clients(sel.vals[None], axis=0)   # (m, k)
    g_idx = ctx.all_gather_clients(sel.idx[None], axis=0)     # (m, k)
    vvals, valid = validate_selection(g_vals, g_idx, domain, max_norm)
    surv = mask * valid
    agg = server_aggregate_sparse_masked(vvals, g_idx, d, surv)
    rejected = (mask * (1.0 - valid)).sum()
    return agg.reshape(leaf.shape), valid[ctx.client_index()], rejected


def sparse_topk_hier_leaf(sel: Selection, leaf, n_eff, ctx):
    """Two-level aggregation of one leaf. Tier 1: the member-axis
    all_gather carries each group's compacted selections, and every group
    scatters its members' entries, client-major, into a fresh dense
    partial. Tier 2 — the root collective — gathers the g partials over
    the group axis and adds them in group order, then divides:
    :func:`server_aggregate_sparse_grouped` exactly."""
    d = leaf.numel()
    g_vals = ctx.all_gather_members(sel.vals[None], axis=0)
    g_idx = ctx.all_gather_members(sel.idx[None], axis=0)
    partial = scatter_add_clients(
        torch.zeros(d + 1, dtype=torch.float32, device=g_vals.device),
        g_vals, g_idx)
    partials = ctx.all_gather_group_partials(partial[None], axis=0)
    total = partials[0]
    for j in range(1, partials.shape[0]):
        total = total + partials[j]
    return _div(total, n_eff)[:d].reshape(leaf.shape)


def packbits(b):
    """(…, n) 0/1 uint8 → (…, ⌈n/8⌉) bytes, MSB first (``jnp.packbits``)."""
    n = b.shape[-1]
    b = torch.nn.functional.pad(b, (0, -n % 8)).view(*b.shape[:-1], -1, 8)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                     device=b.device)
    return (b * w).sum(-1, dtype=torch.uint8)


def unpackbits(b):
    """Inverse of :func:`packbits`: (…, nb) bytes → (…, 8·nb) 0/1 uint8."""
    sh = torch.arange(7, -1, -1, dtype=torch.uint8, device=b.device)
    return ((b[..., None] >> sh) & 1).reshape(*b.shape[:-1], -1)


def packed_sign_leaf(tot, my_mask, n_eff, ctx):
    """Scaled sign with the sign bits packed 8→1 in uint8 for the
    client-axis all_gather (1 bit/coordinate on the wire). The scale
    ``‖tot‖₁/d`` is summed as the port's sign compressor sums it
    (``ref.sign_scale``'s trees, within a few ulp of ``jnp.mean``).
    Returns ``(agg, hat)``; ``hat`` carries sign(0) := +1, as the bits do."""
    flat = tot.reshape(-1)
    d = flat.numel()
    s = ref.sign_scale(flat[None])[0]
    scale = s * (my_mask > 0)
    bits = packbits((flat >= 0).to(torch.uint8))
    g_bits = ctx.all_gather_clients(bits[None], axis=0)       # (m, d/8)
    g_scale = ctx.all_gather_clients(scale[None], axis=0)     # (m,)
    signs = unpackbits(g_bits)[:, :d].float() * 2.0 - 1.0
    agg = _div((g_scale[:, None] * signs).sum(0), n_eff)
    hat = s * torch.where(flat >= 0, 1.0, -1.0)
    return agg.reshape(tot.shape), hat.reshape(tot.shape)


def ef_compress_tree(comp, delta, err, mask, draw):
    """Dense-hat EF over this rank's tree: ``ef_compress_masked`` on each
    flattened leaf, a (1, d_leaf) row (sign/packedsign and blocktopk
    through ``ops.sign_ef``/``ops.topk_ef``: the kernels on CUDA, their
    twins on the CPU); randk's positions come from ``draw``, a generator
    every rank seeds alike (one set per leaf for all clients, as the JAX
    round folds one shared key)."""
    def leaf(dd, ee):
        flat = dd.reshape(-1)
        pos = None
        if comp.name.startswith("randk"):
            k = max(1, int(round(comp.ratio * flat.numel())))
            pos = randk_positions(draw, flat.numel(), k, 1, flat.device)[0]
        h, ne = ef_compress_masked(comp, flat, ee.reshape(-1), mask, pos)
        return h.reshape(dd.shape), ne.reshape(ee.shape)

    return tree_unzip(tree_map(leaf, delta, err), 2)


def mesh_uplink(fed: FedConfig, comp: Optional[Compressor], ctx, kernel_impl,
                draw, delta, my_err, my_mask, n_eff):
    """This rank's delta tree → (aggregated update, next EF error).

    Resolves the aggregation strategy (:func:`mesh_agg_strategy`) — dense
    psum, compacted-Selection gather, or packed-sign gather — applies
    masked error feedback, and narrows the dense collective to
    ``fed.delta_dtype`` with EF tracking the narrowed value. On the sparse
    top-k strategy each leaf is selected ONCE (``fed.mesh_sparse_impl``:
    the ``topk_ef_sparse`` kernel through ``KernelImpl``, or
    ``Compressor.select`` — bit-identical), and the collective carries
    that Selection, never a dense hat. ``draw``: the generator randk's
    positions come from (None for every other compressor)."""
    if comp is None:
        return agg_dense(delta, my_mask, n_eff, ctx, fed.delta_dtype), my_err

    strategy = mesh_agg_strategy(fed)
    if strategy == "packed_sign":
        tot = tree_map(lambda dd, ee: dd + ee, delta, my_err)
        agg, hat = tree_unzip(tree_map(
            lambda t: packed_sign_leaf(t, my_mask, n_eff, ctx), tot), 2)
        new_err = tree_map(
            lambda t, h, eo: torch.where(my_mask > 0, t - h, eo),
            tot, hat, my_err)
        return agg, new_err

    if strategy in ("sparse_topk", "sparse_topk_hier"):
        sels, new_err = mesh_select_tree(fed, comp, kernel_impl, delta,
                                         my_err, my_mask)
        leaf_fn = (sparse_topk_hier_leaf if strategy == "sparse_topk_hier"
                   else sparse_topk_leaf)
        agg = tree_map(lambda s, lf: leaf_fn(s, lf, n_eff, ctx), sels,
                       delta)
        return agg, new_err

    hat, new_err = ef_compress_tree(comp, delta, my_err, my_mask, draw)
    if fed.delta_dtype != "float32":
        # error feedback must track the value actually sent
        wd = getattr(torch, fed.delta_dtype)
        hat = tree_map(lambda h: h.to(wd).float(), hat)
        new_err = tree_map(
            lambda d, e, h: torch.where(my_mask > 0, d + e - h, e),
            delta, my_err, hat)
    return agg_dense(hat, my_mask, n_eff, ctx, fed.delta_dtype), new_err
