"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4 experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]. Experts padded 60->64 for 16-way expert
parallelism (router logits of pad experts pinned to -inf). long_500k via
flagged sliding-window variant."""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                  d_ff_expert=1408, d_ff_shared=5632, capacity_factor=1.25),
    long_context_variant_window=4096,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

smoke = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    qkv_bias=True,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=2,
                  d_ff_expert=64, d_ff_shared=128, capacity_factor=2.0),
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="variant",
                notes="experts padded 60->64 for EP; long_500k via variant")
