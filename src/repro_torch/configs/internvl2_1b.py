"""internvl2-1b [vlm]: InternViT + InternLM2 decoder [arXiv:2404.16821].

We implement the language backbone (InternLM2-1b: llama-arch, GQA 14H/kv2);
the vision encoder + projector are a stub — training inputs are precomputed
patch embeddings (B, S, d_model), per the assignment carve-out. Decode
consumes token ids (text generation). long_500k runs as an explicitly
flagged sliding-window VARIANT (the real model is full-attention)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    frontend="vision",
    long_context_variant_window=4096,
    source="arXiv:2404.16821",
)

smoke = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    frontend="vision",
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="variant",
                notes="vision frontend stubbed; long_500k via sliding-window variant")
