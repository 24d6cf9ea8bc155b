"""The paper-faithful simulation backend: ``FedSim``.

Counterpart of ``repro.core.sim.FedSim``. It runs the paper's Algorithms 1
and 2 on one device: m clients with an (m, d) error-feedback buffer that
stays resident on the device, n sampled clients per round training K local
steps each, the select-once sparse uplink, and the FedAMS server step.

One round (``_round_impl``):

* each sampled client runs K local steps from the model it sees
  (``core.local``) and yields its delta;
* the uplink, sparse or dense:

  - sparse (the top-k family, by default): ``stages.client_uplink_sparse``
    adds the deltas to the clients' EF rows, selects ``(vals, idx)`` once
    per client and leaves the residual in the rows — for blocktopk through
    the ``topk_ef_sparse`` kernel;
  - dense (``sparse_uplink=False``, or sign/int8/identity):
    ``stages.client_uplink`` compresses ``delta + e`` per client and keeps
    ``tot − hat`` in the rows — in memory through the ``sign_ef`` /
    ``topk_ef`` kernels for sign and blocktopk, or, in wire mode, through
    the codec's ``encode_rows``→``decode_rows`` over all n clients at once
    (one ``pack_uint`` and one ``unpack_uint`` launch, whatever
    ``wire_pack_impl`` says); the server averages the hats;

* the server either ingests the selections in one fused pass
  (``fused_ingest`` resolves to ``"kernel"``/``"jnp"``: the
  ``fedams_ingest`` kernel or its plain twin) or takes the two-pass
  ``server_update`` on the mean (the ``fedams_update`` kernel for the
  FedAMS family).

With ``fed.wire=True`` every delta is serialized to packed bytes
(``comm.wire``), timed through a simulated network (``comm.transport``,
host-side numpy keyed by (seed, round, client)) and decoded; the round's
metrics then carry the measured ``wire_*`` bytes, ``round_time_s`` and
``sim_time_s`` (``comm.metrics.CommLog``) next to the analytic ``bits``.

Differences from the JAX class: the state holds the FLAT (d,) model
(``FedSim.unravel`` gives the dict of views in JAX shapes); a round updates
the input state's EF buffer in place, as the JAX round donates it, so keep
only the returned state; per-client local training is a loop of
``torch.autograd`` steps; ``run_rounds`` is a plain loop.

Knobs outside this slice raise ``NotImplementedError`` naming the knob:
``fault``/``deadline_s``, ``async_buffer``, ``ef_store``,
``client_chunk``, ``agg_groups > 1`` and ``two_way``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm.metrics import CommLog
from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
from repro_torch.comm.wire import make_dense32_codec, make_wire_codec
from repro_torch.configs.base import FedConfig
from repro_torch.core.compressors import (Compressor, block_layout,
                                          make_compressor)
from repro_torch.core.local import (hetero_step_counts, local_lr,
                                    make_local_update, run_local_steps)
from repro_torch.core.server_opt import (FUSED_INGEST_GROUPS_DETAIL,
                                         init_server_state, server_ingest,
                                         server_update)
from repro_torch.core.stages import (client_uplink, client_uplink_sparse,
                                     gamma_diagnostic, resolve_fused_ingest,
                                     server_aggregate_sparse, server_downlink,
                                     stage)
from repro_torch.models.params import ravel


class SimState(NamedTuple):
    params: torch.Tensor        # (d,) flat model (ravel_pytree order)
    opt: object                 # ServerState over the flat vector
    errors: torch.Tensor        # (m, d) per-client EF errors
    server_error: torch.Tensor  # (d,) server-side EF error (two-way mode)
    x_client: torch.Tensor      # (d,) model as clients see it
    bits: int                   # cumulative one-way communicated bits
    round: int


def _refuse_unported(fed: FedConfig) -> None:
    unported = {
        "deadline_s": fed.deadline_s > 0,
        "async_buffer": fed.async_buffer > 0,
        "ef_store": fed.ef_store,
        "client_chunk": fed.client_chunk > 0,
        "agg_groups": fed.agg_groups > 1,
        "two_way": fed.two_way,
    }
    for knob, on in unported.items():
        if on:
            raise NotImplementedError(
                f"FedConfig.{knob}={getattr(fed, knob)!r}: not ported to "
                f"repro_torch's FedSim yet")


class FedSim:
    """Federated simulation over ``loss_fn(params_dict, batch) -> (loss,
    aux)``, where ``params_dict`` holds tensors in the JAX shapes.

    ``device``: where the state and the round run; ``None`` means CUDA and
    raises without a card (pass ``device="cpu"`` to run on the CPU).
    ``network``: the wire mode's ``comm.transport.SimulatedNetwork``
    (default: ``NetworkConfig()`` over ``fed.num_clients``)."""

    def __init__(self, loss_fn: Callable, fed: FedConfig,
                 compressor: Optional[Compressor] = None,
                 network: Optional[SimulatedNetwork] = None, *, device=None):
        _refuse_unported(fed)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.fed = fed
        self.rule = make_local_update(fed)
        if compressor is None and fed.algorithm == "fedcams":
            compressor = make_compressor(fed.compressor, fed.compress_ratio,
                                         fed.wire_block)
        self.comp = compressor if fed.algorithm == "fedcams" else None
        self.sparse = (self.comp is not None
                       and self.comp.select is not None
                       if fed.sparse_uplink is None
                       else bool(fed.sparse_uplink))
        if self.sparse and (self.comp is None or self.comp.select is None):
            raise ValueError(
                "sparse_uplink=True needs a compressor with a .select "
                "(topk/blocktopk family); this one has none")
        eligible = (self.sparse and self.comp.name.startswith("blocktopk")
                    and not fed.track_gamma)
        self._fused = resolve_fused_ingest(
            fed, eligible=eligible, have_kernel=True,
            compiled=self.device.type == "cuda",
            detail="FedSim fuses only the sparse blocktopk uplink with "
                   "track_gamma=False (the γ diagnostic consumes a dense "
                   "aggregate)" + FUSED_INGEST_GROUPS_DETAIL)
        self.unravel = None
        self.codec = self.network = self.comm_log = None
        if network is not None and not fed.wire:
            raise ValueError(
                "a network was supplied but fed.wire is False — the "
                "transport simulation only runs in wire mode; set "
                "FedConfig(wire=True)")
        if fed.wire:
            name = fed.compressor if self.comp is not None else "dense32"
            self.codec = make_wire_codec(name, fed.compress_ratio,
                                         fed.wire_block, fed.wire_value_dtype)
            self._down_codec = make_dense32_codec()   # two_way is refused
            self.network = network or SimulatedNetwork(NetworkConfig(),
                                                       fed.num_clients)
            self.comm_log = CommLog()

    def init(self, params) -> SimState:
        """``params``: a nested dict of tensors in JAX shapes."""
        flat, self.unravel = ravel(params)
        flat = flat.to(self.device, torch.float32).clone()
        d = flat.numel()
        self._d = d
        self._ingest_block = block_layout(d, self.fed.wire_block)[0]
        return SimState(
            params=flat,
            opt=init_server_state(flat, self.fed.server_state_dtype,
                                  self._ingest_block),
            errors=torch.zeros((self.fed.num_clients, d), dtype=torch.float32,
                               device=self.device),
            server_error=torch.zeros(d, dtype=torch.float32,
                                     device=self.device),
            x_client=flat,
            bits=0,
            round=0,
        )

    def _bits_per_round(self, n: int) -> int:
        """Analytic one-way bits for one round (exact host-side int)."""
        if self.comp is not None:
            return n * int(self.comp.bits_per_message(self._d))
        return n * 32 * self._d

    def _round_timing(self, ids, round_idx: int):
        """Simulated-network timing draw for one round (host-side numpy,
        deterministic in (seed, round, client)); None outside wire mode."""
        if self.network is None:
            return None
        return self.network.round(ids, self.codec.nbytes(self._d),
                                  self._down_codec.nbytes(self._d), round_idx)

    def _record_timing(self, timing) -> dict:
        """Book one round's timing into the CommLog and return its metric
        entries (every client's payload is delivered: no faults here)."""
        return self.comm_log.record(timing)

    # -- one round ---------------------------------------------------------
    def round(self, state: SimState, client_batches, client_idx,
              rng: Optional[torch.Generator] = None):
        """``client_batches``: dict of arrays with leading (n, K, ...);
        ``client_idx``: (n,) distinct client ids (host array or tensor);
        ``rng``: a ``torch.Generator``, needed only for heterogeneous step
        counts. The input state's EF buffer is updated in place."""
        if isinstance(client_idx, torch.Tensor):
            client_idx = client_idx.cpu().numpy()
        ids = np.array(client_idx, dtype=np.int64)
        if np.unique(ids).size != ids.size:
            raise ValueError("client_idx must hold distinct client ids")
        with stage("host_to_device"):
            idx = torch.as_tensor(ids, device=self.device)
            batches = {k: torch.as_tensor(v).to(self.device)
                       for k, v in client_batches.items()}
        k_all = hetero_step_counts(self.fed, rng, ids.size)
        timing = self._round_timing(ids, state.round)
        new_state, met = self._round_impl(state, batches, idx, state.round,
                                          k_all)
        bits = state.bits + self._bits_per_round(ids.size)
        met["bits"] = bits
        if timing is not None:
            met.update(self._record_timing(timing))
        return new_state._replace(bits=bits, round=state.round + 1), met

    def run_rounds(self, state: SimState, client_batches, client_idx,
                   rngs=None):
        """R rounds as a loop of :meth:`round`. ``client_batches``: leading
        (R, n, K, ...); ``client_idx``: (R, n); ``rngs``: R generators or
        None. Returns ``(new_state, mets)``."""
        mets = []
        for r in range(len(client_idx)):
            b_r = {k: v[r] for k, v in client_batches.items()}
            state, met = self.round(state, b_r, client_idx[r],
                                    None if rngs is None else rngs[r])
            mets.append(met)
        return state, mets

    def _grad(self, p, batch):
        p = p.detach().requires_grad_(True)
        loss, _ = self.loss_fn(self.unravel(p), batch)
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g

    def _train_block(self, flat0, batches, eta_l, k_blk=None):
        """Local training for every client → ((n, d) deltas, (n,) losses)."""
        n = next(iter(batches.values())).shape[0]
        deltas, losses = [], []
        for i in range(n):
            local, loss = run_local_steps(
                self.rule, self._grad, flat0,
                {k: v[i] for k, v in batches.items()}, eta_l,
                None if k_blk is None else k_blk[i])
            deltas.append(local - flat0)
            losses.append(loss)
        return torch.stack(deltas), torch.stack(losses)

    def _round_impl(self, state: SimState, batches, client_idx, round_idx,
                    k_all):
        fed = self.fed
        n = client_idx.numel()
        flat0 = state.x_client
        d = flat0.numel()
        with stage("local_training"):
            delta, losses = self._train_block(flat0, batches,
                                              local_lr(fed, round_idx), k_all)
            loss = losses.mean()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        errors = state.errors
        mean_tot = None
        with stage("uplink"):
            if fed.track_gamma and self.comp is not None:
                # the diagnostic needs the EF totals before the uplink
                mean_tot = (errors[client_idx] + delta).mean(dim=0)
            if self.sparse:
                vals, sidx = client_uplink_sparse(self.comp, errors,
                                                  client_idx, delta,
                                                  self._ingest_block,
                                                  self.codec)
            else:
                hats = client_uplink(self.comp, self.codec, d, delta, errors,
                                     client_idx)
        if self.sparse and self._fused != "off":
            # one-pass fused ingest: the selections go straight into the
            # m/v/v̂/x update, no dense mean delta
            with stage("server_ingest"):
                new_flat, opt = server_ingest(
                    fed, state.opt, state.params, vals, sidx, n,
                    block=self._ingest_block, impl=self._fused)
            gamma = zero
        else:
            with stage("server_aggregate"):
                agg = (server_aggregate_sparse(vals, sidx, d, n)
                       if self.sparse else hats.mean(dim=0))
            with stage("gamma"):
                gamma = (gamma_diagnostic(self.comp, mean_tot, agg,
                                          delta.mean(dim=0))
                         if fed.track_gamma else zero)
            with stage("server_update"):
                new_flat, opt = server_update(fed, state.opt, state.params,
                                              agg)
        with stage("downlink"):
            x_client, server_error = server_downlink(
                fed, self.comp, new_flat, state.x_client, state.server_error)
        return (state._replace(params=new_flat, opt=opt, errors=errors,
                               server_error=server_error, x_client=x_client),
                {"loss": loss, "gamma": gamma})
