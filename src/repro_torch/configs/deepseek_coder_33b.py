"""deepseek-coder-33b [dense]: llama-arch GQA 56H/kv8 [arXiv:2401.14196].
long_500k via flagged sliding-window variant."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    long_context_variant_window=4096,
    source="arXiv:2401.14196",
)

smoke = ModelConfig(
    name="deepseek-coder-33b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=320,
    vocab_size=512,
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="variant",
                notes="long_500k via sliding-window variant")
