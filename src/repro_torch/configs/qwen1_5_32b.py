"""qwen1.5-32b [dense]: llama-arch with QKV bias [hf:Qwen/Qwen1.5-0.5B
family card]. long_500k via flagged sliding-window variant."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_variant_window=4096,
    source="hf:Qwen/Qwen1.5-32B",
)

smoke = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=320,
    vocab_size=512,
    qkv_bias=True,
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="variant",
                notes="long_500k via sliding-window variant")
