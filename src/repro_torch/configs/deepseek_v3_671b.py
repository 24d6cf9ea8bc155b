"""deepseek-v3-671b [moe]: MLA + 1 shared/256 routed top-8 MoE + MTP
[arXiv:2412.19437].

Deviations (DESIGN.md §7): all 61 layers are MoE (the real model's first 3
are dense) so the layer stack scans uniformly. MLA dims follow the report
(kv_lora 512, q_lora 1536, rope 64, nope/v 128). FL runs in hierarchical
per-pod client mode: a 16-way-TP replica cannot hold 671B params, so the
whole pod slice is one cross-silo client with internal data parallelism.
long_500k is allowed natively: the MLA latent cache is 576 floats/position
and decode cost is linear in context."""
from repro_torch.configs.base import MLAConfig, MTPConfig, ModelConfig, MoEConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=0,
    vocab_size=129280,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                  d_ff_expert=2048, d_ff_shared=2048, capacity_factor=1.25),
    mtp=MTPConfig(depth=1, loss_weight=0.3),
    source="arXiv:2412.19437",
)

smoke = ModelConfig(
    name="deepseek-v3-671b-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=0,
    vocab_size=512,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32),
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                  d_ff_expert=64, d_ff_shared=64, capacity_factor=2.0),
    mtp=MTPConfig(depth=1, loss_weight=0.3),
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, client_mode="per_pod",
                long_500k="native",
                notes="all-MoE stack (real model: first 3 dense); per-pod FL client")
