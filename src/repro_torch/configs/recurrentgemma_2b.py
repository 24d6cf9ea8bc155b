"""recurrentgemma-2b [hybrid]: Griffin — RG-LRU + local attention, pattern
(rec, rec, attn) [arXiv:2402.19427]. 26 layers = 8 full periods + 2 tail
recurrent layers (handled unscanned). long_500k native: recurrent state is
O(1), attention layers are windowed (2048)."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    attn_pattern=(2048,),
    sliding_window=2048,
    act="gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    source="arXiv:2402.19427",
)

smoke = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    block_pattern=("rglru", "attn"),
    attn_pattern=(16,),
    act="gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=128, conv_width=4),
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="native",
                notes="RG-LRU+local attn; long_500k native")
