"""Configuration dataclasses: the model zoo's ``ModelConfig`` (and its
MoE/MLA/RG-LRU/xLSTM/MTP sub-configs), ``FedConfig`` (the federated
algorithm family, selectable per run), ``TrainConfig`` (the training
loop's settings), ``MeshConfig``/``ShapeConfig``/``INPUT_SHAPES`` and
``ExperimentConfig``.

Copies of the classes of ``repro.configs.base`` with identical field
names, defaults and validation, so a config means the same thing in both
packages (tests/test_torch_imports.py, tests/test_torch_faults.py and
tests/test_torch_models.py hold the two side by side). The port does not
import ``repro``, so the classes are copied rather than shared; ``fault``
takes the port's own ``repro_torch.comm.faults.FaultConfig``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (DeepSeek-V3 / Qwen-MoE style)."""

    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert FFN hidden size
    d_ff_shared: int = 0          # total shared-expert FFN hidden size
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None
    aux_loss_weight: float = 1e-3


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention dims."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin RG-LRU recurrent block."""

    lru_width: int = 0            # 0 => d_model
    conv_width: int = 4           # temporal conv in the recurrent block
    c_constant: float = 8.0       # a = exp(-c * softplus(Λ) * sigmoid(gate))


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack (mLSTM + sLSTM alternating)."""

    pattern: Tuple[str, ...] = ("mlstm", "slstm")
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4
    # chunkwise-recurrent mLSTM (the xLSTM paper's O(S·c) form): replaces
    # the O(S²) parallel decay matrices; §Perf optimization, numerics equal.
    chunkwise: bool = False
    chunk_size: int = 256


@dataclass(frozen=True)
class MTPConfig:
    """DeepSeek-V3 multi-token-prediction auxiliary head."""

    depth: int = 1
    loss_weight: float = 0.3


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 => d_model // num_heads
    source: str = ""                    # citation (arXiv / hf card)

    # --- block pattern -----------------------------------------------------
    # Per-layer block kinds, repeated/truncated to num_layers. Kinds:
    #   "attn"  : softmax attention (window controlled by attn_pattern)
    #   "rglru" : Griffin recurrent block
    #   "mlstm" / "slstm" : xLSTM blocks
    block_pattern: Tuple[str, ...] = ("attn",)
    # Per-attention-layer window pattern: entries are window sizes; 0 = global.
    attn_pattern: Tuple[int, ...] = (0,)

    sliding_window: int = 4096          # window used by "local" attention entries
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"                   # silu | gelu
    gated_ffn: bool = True              # gated (xGLU) FFN; False = classic MLP
    tie_embeddings: bool = False
    is_encoder: bool = False            # encoder-only (no causal mask, no decode)
    frontend: Optional[str] = None      # None | "audio" | "vision"
    # For long_500k on otherwise-full-attention archs: run a sliding-window
    # VARIANT (flagged deviation, see DESIGN.md).
    long_context_variant_window: int = 0   # 0 = arch cannot run long_500k

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    mtp: Optional[MTPConfig] = None

    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            raise ValueError("block_pattern must be non-empty")

    # -- derived -------------------------------------------------------
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind for each of the num_layers layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def layer_windows(self) -> Tuple[int, ...]:
        """Attention window per layer (0 = global); meaningless for non-attn."""
        p = self.attn_pattern
        out = []
        ai = 0
        for kind in self.layer_kinds:
            if kind == "attn":
                out.append(p[ai % len(p)])
                ai += 1
            else:
                out.append(0)
        return tuple(out)

    def num_params(self) -> int:
        """Approximate true (unpadded) parameter count."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        for kind in self.layer_kinds:
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qh = m.nope_head_dim + m.rope_head_dim
                    total += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qh
                    total += d * (m.kv_lora_rank + m.rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * self.num_heads * hd          # q
                    total += 2 * d * self.num_kv_heads * hd   # k, v
                    total += self.num_heads * hd * d          # o
            elif kind == "rglru":
                w = self.rglru.lru_width or d
                total += 2 * d * w + w * d + 3 * w + self.rglru.conv_width * w
            elif kind == "mlstm":
                pf = self.xlstm.mlstm_proj_factor
                di = int(d * pf)
                total += 2 * d * di + 3 * di * di // max(self.num_heads, 1) + di * d
            elif kind == "slstm":
                pf = self.xlstm.slstm_proj_factor
                total += 4 * d * d + 4 * d * d // max(self.num_heads, 1)
                total += int(2 * d * d * pf)
            # FFN
            if self.moe is not None and kind == "attn":
                mo = self.moe
                total += d * mo.num_experts                    # router
                total += mo.num_experts * 3 * d * mo.d_ff_expert
                total += mo.num_shared_experts * 3 * d * max(mo.d_ff_shared, mo.d_ff_expert)
            elif kind in ("attn", "rglru") and ff > 0:
                total += 3 * d * ff if self.gated_ffn else 2 * d * ff
        return total

    def num_active_params(self) -> int:
        """Active params per token (= num_params for dense)."""
        if self.moe is None:
            return self.num_params()
        mo = self.moe
        d = self.d_model
        full = self.num_params()
        all_expert = self.num_layers * mo.num_experts * 3 * d * mo.d_ff_expert
        active_expert = self.num_layers * mo.top_k * 3 * d * mo.d_ff_expert
        return full - all_expert + active_expert


# ---------------------------------------------------------------------------
# Federated / training / mesh configs
# ---------------------------------------------------------------------------


#: Known values for the validated FedConfig string fields (a typo should
#: fail at construction, not deep inside the traced server_update).
FED_ALGORITHMS = ("fedavg", "fedadagrad", "fedadam", "fedyogi",
                  "fedamsgrad", "fedams", "fedcams")
FED_COMPRESSORS = ("topk", "blocktopk", "sign", "packedsign", "randk",
                   "int8", "none", "identity")
FED_AGGREGATIONS = ("dense", "sparse")
FED_MESH_SPARSE_IMPLS = ("auto", "kernel", "jnp")
FED_FUSED_INGEST = ("auto", "kernel", "jnp", "off")
FED_SERVER_STATE_DTYPES = ("float32", "bfloat16", "int8")
FED_LOCAL_OPTS = ("sgd", "sgdm", "prox")
#: Staleness-weight rules for the async buffered engine
#: (comm/async_engine.py): w(τ) applied to a delivery that trained on a
#: model τ server versions old. "inv_sqrt" is FedBuff's 1/sqrt(1+τ).
FED_STALENESS_WEIGHTS = ("inv_sqrt", "uniform", "inv_linear", "exp")


@dataclass(frozen=True)
class FedConfig:
    """The paper's algorithm family, selectable per-experiment."""

    algorithm: str = "fedcams"     # fedavg|fedadam|fedyogi|fedamsgrad|fedams|fedcams
    option: int = 1                # FedAMS max-stabilization Option 1 or 2
    eta: float = 1.0               # global (server) lr
    eta_l: float = 0.01            # local lr
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-3              # max-stabilization epsilon
    local_steps: int = 4           # K
    # -- local-update rule (core/local.py, DESIGN.md §8): how a client turns
    # K gradients into its delta. The convergence theory is agnostic to it;
    # "sgd" is the paper's plain local SGD (bit-identical default).
    local_opt: str = "sgd"         # sgd | sgdm | prox
    local_momentum: float = 0.9    # heavy-ball beta for local_opt="sgdm"
    prox_mu: float = 0.01          # proximal strength for local_opt="prox"
    # Per-round local LR schedule: round t trains at eta_l * eta_l_decay^t.
    # 1.0 = constant (bit-identical to the unscheduled round).
    eta_l_decay: float = 1.0
    # Heterogeneous per-client local work: when > 0, client i runs
    # K_i ~ Uniform{local_steps_min..local_steps} steps this round (masked
    # inside the scanned local step, so the trace stays static-shaped).
    # 0 = every client runs the full local_steps.
    local_steps_min: int = 0
    num_clients: int = 16          # m
    participating: int = 0         # n; 0 => full participation
    compressor: str = "topk"       # topk|blocktopk|sign|packedsign|randk|int8|none
    compress_ratio: float = 1.0 / 64.0   # r = k/d for top-k family
    # FedSim select-once sparse uplink (DESIGN.md §3): the top-k selection
    # runs once per client and the (vals, idx) pair flows end-to-end into an
    # O(n·k + d) server scatter — no dense per-client hat, no dense (n, d)
    # mean. None = auto (on for the topk/blocktopk family), False = force
    # the dense reference path, True = require it (rejects compressors with
    # no compacted form). Selection and error feedback are bit-identical to
    # the dense path; the aggregate matches up to scatter-vs-reduce
    # float reassociation on coordinates several clients selected.
    sparse_uplink: Optional[bool] = None
    aggregation: str = "dense"     # dense | sparse  (see DESIGN.md §3)
    # Mesh sparse aggregation: who computes the per-leaf blockwise top-k
    # selection the client-axis all_gather carries (DESIGN.md §3).
    # "auto" = the fused Pallas kernel (kernels/topk_ef.py::topk_ef_sparse,
    # one HBM pass emitting the compacted (vals, idx) block + the EF
    # residual) when a KernelImpl is supplied and compiles for the backend
    # (TPU), the jnp Compressor.select path otherwise; "kernel"/"jnp" force
    # one side (forcing "kernel" off-TPU runs the Pallas interpreter —
    # bit-identical, test-only speed). Selection and EF are bit-identical
    # across impls (tests/test_kernels.py, tests/test_mesh_parity.py).
    mesh_sparse_impl: str = "auto"  # auto | kernel | jnp
    # One-pass fused server ingest (DESIGN.md §3): scatter-mean + the full
    # FedAMS m/v/v̂/x update in a single read-modify-write over optimizer
    # state — the dense mean delta is never materialized. "auto" = fuse
    # whenever the round is eligible (sparse blocktopk uplink, no gamma
    # diagnostic / client chunking / state sharding), picking the Pallas
    # kernel (kernels/fedams_ingest.py) where it compiles (TPU) and the
    # blocked-scatter jnp path elsewhere; "kernel"/"jnp" force one side
    # (build-time error when the round cannot fuse); "off" = the two-pass
    # baseline (server_aggregate_sparse + server_update). Bit-identical to
    # the two-pass path at float32 state (tests/test_fused_ingest.py).
    fused_ingest: str = "auto"      # auto | kernel | jnp | off
    # Server second-moment (v, v̂) storage dtype: bf16 halves and
    # int8-blockscale (one fp32 absmax scale per wire_block) quarters the
    # optimizer-state HBM residency; the update math always runs in fp32,
    # dequant/requant fused into the ingest pass. Non-fp32 requires an
    # algorithm that overwrites v/v̂ every round (fedams family) — a
    # passthrough state would drift under requantization. int8 is
    # simulation-only (the blockscale layout has no mesh ParamDef form).
    server_state_dtype: str = "float32"  # float32 | bfloat16 | int8
    # Compute the per-round Assumption 4.17 γ diagnostic (paper Fig. 6).
    # It costs an extra dense compression of the mean total per round;
    # production-style perf runs turn it off and the history reports
    # gamma=0.0 (metric keys unchanged).
    track_gamma: bool = True
    delta_dtype: str = "float32"   # wire dtype for the dense client collective
    two_way: bool = False          # beyond-paper: compress server->client too
    # -- wire mode (repro.comm): encode every delta to packed bytes, move
    # it through the simulated network, decode server-side; history gains
    # measured wire_bytes / round_time_s next to the analytic bits.
    wire: bool = False
    wire_value_dtype: str = "float32"  # float32 = bit-exact vs the dense path
    wire_block: int = 2048         # codec block size (blocktopk/bitpack)
    # jnp | pallas: the JAX package's sub-word packing route (XLA or
    # Pallas, byte-identical). Kept for parity; the port packs through
    # kernels.ops.pack_uint (the kernel on a card) for either value.
    wire_pack_impl: str = "jnp"
    # FedSim: process the per-client train/compress/encode pipeline in
    # chunks of this many clients (lax.scan over n/client_chunk chunks), so
    # peak delta memory is (client_chunk, d) instead of (n, d). 0 = off.
    client_chunk: int = 0
    # -- million-client scale-out (DESIGN.md §scale-out) -------------------
    # FedSim: hold the per-client EF error rows host-side in a lazily
    # materialized shard store (checkpoint.store.EFStore) instead of the
    # device-resident (m, d) buffer. Each round gathers only the
    # participating cohort's rows to device and scatters them back after
    # the uplink, so peak device memory is (participating, d) not (m, d) —
    # the enabler for m = 10^6. Loss is bit-identical to the resident
    # buffer (same rows, same math; tests/test_scale_out.py). FedSim-only:
    # the mesh backend already shards EF over the client axes.
    ef_store: bool = False
    # Two-level hierarchical sparse aggregation: clients are partitioned
    # into this many groups; each group pre-merges its members' compacted
    # (vals, idx) selections into a dense partial (tier 1, the existing
    # blocked scatter) and the root consumes the g group partials (tier 2)
    # instead of n client messages. 1 = flat (bit-identical to before).
    # Requires the sparse (vals, idx) pipeline (topk/blocktopk family); on
    # the mesh the FIRST client axis is the group axis. The aggregate
    # matches flat up to ≤1-ulp reassociation on coordinates selected by
    # clients in several groups (the scatter-collision analysis, now across
    # group partials — tests/test_mesh_parity.py).
    agg_groups: int = 1
    # -- fault-tolerant rounds (DESIGN.md §robustness, comm/faults.py) -----
    # Server round deadline in simulated seconds: clients whose simulated
    # finish time exceeds it are cut from the round (their EF residual
    # stays stale and repays on rejoin). Turns the straggler max in
    # T_round into a quantile. FedSim wire mode only (needs the transport
    # clock); 0 = wait for every survivor. Shorthand for a deadline-only
    # FaultConfig — set either this or fault.deadline_s, not both.
    deadline_s: float = 0.0
    # -- event-driven async buffered rounds (DESIGN.md §11,
    # comm/async_engine.py) -----------------------------------------------
    # FedSim wire mode: instead of the server waiting for the whole cohort
    # (T_round = straggler max), a host-side event clock orders per-client
    # delivery times and the server fires one buffered aggregation every
    # time this many deliveries accumulate, weighting each entry by its
    # staleness (FedBuff-style). 0 = synchronous rounds. Must be in
    # [1, cohort]; with async_buffer == cohort and "uniform" weights the
    # engine is bit-identical to the sync round (the parity anchor).
    # Requires the sparse (vals, idx) pipeline — the flush consumes a
    # fixed-shape (buffer, k) Selection batch through the validated
    # weighted scatter. Deadline cutoffs are the competing strategy
    # (drop late work vs reweight it): setting both is rejected.
    async_buffer: int = 0
    # w(τ) rule for async deliveries, τ = server versions elapsed since
    # the entry's cohort was dispatched: inv_sqrt = 1/sqrt(1+τ) (FedBuff),
    # uniform = 1.0, inv_linear = 1/(1+τ), exp = exp(-τ/2).
    staleness_weight: str = "inv_sqrt"
    # Full fault model: crash probability / scheduled outages / payload
    # corruption + validation-before-ingest knobs. None = fault-free
    # (bit-identical to a build without the fault machinery). When set,
    # both backends thread a survivor mask through the round: the
    # aggregate is a masked scatter/mean over survivors and the server
    # validates decoded payloads (NaN/Inf, index range, optional norm
    # clip) before they can touch the FedAMS m/v/v̂ state.
    fault: Optional[object] = None   # comm.faults.FaultConfig
    client_axes: Tuple[str, ...] = ("data",)   # mesh axes that enumerate clients
    use_kernels: bool = False      # use Pallas kernels for compress+server update
    # ZeRO-style sharding of the server optimizer state (m, v, v_hat) over
    # the client axes (or "data" in hierarchical mode): the update is
    # elementwise, so each shard owns a slice and the refreshed params are
    # all-gathered once per round.
    shard_server_state: bool = False
    state_shards: int = 0          # resolved from the mesh by launch.steps

    def __post_init__(self):
        def check(field, value, known):
            if value not in known:
                raise ValueError(
                    f"FedConfig.{field}={value!r} is not one of {known}")
        check("algorithm", self.algorithm, FED_ALGORITHMS)
        check("option", self.option, (1, 2))
        check("compressor", self.compressor, FED_COMPRESSORS)
        check("aggregation", self.aggregation, FED_AGGREGATIONS)
        check("mesh_sparse_impl", self.mesh_sparse_impl,
              FED_MESH_SPARSE_IMPLS)
        check("fused_ingest", self.fused_ingest, FED_FUSED_INGEST)
        check("server_state_dtype", self.server_state_dtype,
              FED_SERVER_STATE_DTYPES)
        if (self.server_state_dtype != "float32"
                and self.algorithm not in ("fedams", "fedcams",
                                           "fedamsgrad")):
            raise ValueError(
                f"FedConfig.server_state_dtype={self.server_state_dtype!r} "
                f"requires an algorithm that overwrites v/v̂ every round "
                f"(fedams/fedcams/fedamsgrad) — {self.algorithm!r} would "
                f"requant-drift passthrough state")
        if self.server_state_dtype == "int8" and self.shard_server_state:
            raise ValueError(
                "FedConfig.server_state_dtype='int8' is incompatible with "
                "shard_server_state — the blockscale layout does not "
                "slice along the state-shard axes")
        check("local_opt", self.local_opt, FED_LOCAL_OPTS)
        check("wire_pack_impl", self.wire_pack_impl, ("jnp", "pallas"))
        check("sparse_uplink", self.sparse_uplink, (None, True, False))
        if self.sparse_uplink and self.compressor not in ("topk",
                                                          "blocktopk"):
            raise ValueError(
                f"FedConfig.sparse_uplink=True requires a (value, index) "
                f"compressor (topk/blocktopk), got {self.compressor!r}")
        if not 0.0 < self.eta_l_decay <= 1.0:
            raise ValueError(
                f"FedConfig.eta_l_decay={self.eta_l_decay} must be in (0, 1]")
        if self.local_steps_min < 0 or self.local_steps_min > self.local_steps:
            raise ValueError(
                f"FedConfig.local_steps_min={self.local_steps_min} must be "
                f"in [0, local_steps={self.local_steps}]")
        if self.agg_groups < 1:
            raise ValueError(
                f"FedConfig.agg_groups={self.agg_groups} must be >= 1")
        if self.agg_groups > 1:
            if self.compressor not in ("topk", "blocktopk"):
                raise ValueError(
                    f"FedConfig.agg_groups={self.agg_groups} requires the "
                    f"sparse (vals, idx) pipeline — a (value, index) "
                    f"compressor (topk/blocktopk), got {self.compressor!r}")
            n_round = self.participating or self.num_clients
            if n_round % self.agg_groups:
                raise ValueError(
                    f"FedConfig.agg_groups={self.agg_groups} must divide "
                    f"the per-round client count n={n_round} — ragged "
                    f"groups would silently skew the tier-1 partials")
        if self.deadline_s < 0:
            raise ValueError(
                f"FedConfig.deadline_s={self.deadline_s} must be >= 0")
        if self.fault is not None or self.deadline_s > 0:
            from repro_torch.comm.faults import FaultConfig
            if self.fault is not None and not isinstance(self.fault,
                                                         FaultConfig):
                raise ValueError(
                    f"FedConfig.fault must be a comm.faults.FaultConfig, "
                    f"got {type(self.fault).__name__}")
            if self.deadline_s > 0 and self.fault is not None \
                    and self.fault.deadline_s > 0:
                raise ValueError(
                    f"both FedConfig.deadline_s={self.deadline_s} and "
                    f"FedConfig.fault.deadline_s="
                    f"{self.fault.deadline_s} are set — pick one")
            deadline = self.deadline_s or (
                self.fault.deadline_s if self.fault is not None else 0.0)
            if deadline > 0 and not self.wire:
                raise ValueError(
                    "a round deadline (deadline_s > 0) needs the simulated "
                    "transport clock — set FedConfig(wire=True); the mesh "
                    "backend has no per-client times to cut against")
            if self.track_gamma:
                raise ValueError(
                    "FedConfig.fault/deadline_s requires track_gamma="
                    "False — the γ diagnostic consumes the dense mean "
                    "over the FULL cohort, which a partial round no "
                    "longer computes")
            if self.agg_groups > 1:
                raise ValueError(
                    "FedConfig.fault/deadline_s is incompatible with "
                    "agg_groups > 1 — the two-level group partials have "
                    "no per-client survivor masking yet")
            if self.client_chunk:
                raise ValueError(
                    "FedConfig.fault/deadline_s is incompatible with "
                    "client_chunk — the chunked scan accumulates dense "
                    "running sums the survivor mask cannot thread "
                    "through; run the unchunked round")
        check("staleness_weight", self.staleness_weight,
              FED_STALENESS_WEIGHTS)
        if self.async_buffer < 0:
            raise ValueError(
                f"FedConfig.async_buffer={self.async_buffer} must be >= 0")
        if self.async_buffer > 0:
            n_round = self.participating or self.num_clients
            if self.async_buffer > n_round:
                raise ValueError(
                    f"FedConfig.async_buffer={self.async_buffer} exceeds "
                    f"the cohort size n={n_round} — a flush would wait on "
                    f"more deliveries than one dispatch provides")
            if not self.wire:
                raise ValueError(
                    "FedConfig.async_buffer needs the simulated transport "
                    "clock — set FedConfig(wire=True); without per-client "
                    "delivery times there is no event order to buffer")
            if self.compressor not in ("topk", "blocktopk") \
                    or self.sparse_uplink is False:
                raise ValueError(
                    "FedConfig.async_buffer requires the select-once "
                    "sparse (vals, idx) uplink (topk/blocktopk, "
                    "sparse_uplink not False) — the buffered flush "
                    "consumes a fixed-shape Selection batch through the "
                    "validated weighted scatter")
            if self.track_gamma:
                raise ValueError(
                    "FedConfig.async_buffer requires track_gamma=False — "
                    "the γ diagnostic consumes the dense mean over a full "
                    "synchronous cohort, which a buffered flush never "
                    "forms")
            if self.two_way:
                raise ValueError(
                    "FedConfig.async_buffer is incompatible with two_way "
                    "— in-flight clients trained on a model the server-"
                    "side downlink EF stream has since rewritten")
            if self.agg_groups > 1 or self.client_chunk or self.ef_store:
                raise ValueError(
                    "FedConfig.async_buffer is incompatible with "
                    "agg_groups/client_chunk/ef_store — the buffered "
                    "flush is a flat fixed-shape (buffer, k) batch")
            deadline = self.deadline_s or (
                self.fault.deadline_s if self.fault is not None else 0.0)
            if deadline > 0:
                raise ValueError(
                    "FedConfig.async_buffer and a round deadline are "
                    "competing straggler strategies (reweight late work "
                    "vs drop it) — set one")


@dataclass(frozen=True)
class TrainConfig:
    """The training loop's settings (a copy of
    ``repro.configs.base.TrainConfig``, same fields and defaults). The
    simulation backend's ``FederatedTrainer`` reads ``rounds``,
    ``log_every``, ``checkpoint_every`` and ``seed``; the mesh backend
    also ``global_batch``, ``seq_len``, ``remat_policy`` and
    ``tp_collective`` (the model axis's all-reduce); ``microbatch`` is
    read by no code of the port yet."""

    global_batch: int = 256
    seq_len: int = 4096
    rounds: int = 100
    microbatch: int = 0           # 0 = no microbatching within a local step
    remat_policy: str = "full"    # full | dots | none
    tp_collective: str = "psum"   # psum | rs_ag (see ParallelContext)
    log_every: int = 10
    checkpoint_every: int = 0
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def tp(self) -> int:
        return self.shape[self.axes.index("model")]

    @property
    def dp(self) -> int:
        return self.shape[self.axes.index("data")]


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig
    fed: FedConfig = field(default_factory=FedConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def mreplace(cfg, **kw):
    """dataclasses.replace that tolerates nested dataclass fields."""
    return dataclasses.replace(cfg, **kw)
