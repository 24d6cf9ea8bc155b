"""gemma2-2b [dense]: alternating local/global attention with softcaps,
head_dim 256 [arXiv:2408.00118]. long_500k native (as gemma2-27b)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_pattern=(4096, 0),
    sliding_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118",
)

smoke = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    attn_pattern=(16, 0),
    logit_softcap=30.0,
    attn_softcap=50.0,
    act="gelu",
    tie_embeddings=True,
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="native",
                notes="alternating local/global; long_500k native")
