"""gemma2-27b [dense]: alternating local(4096)/global attention, logit
softcap 30 / attention softcap 50, head_dim 128 [arXiv:2408.00118].
long_500k runs natively: half the layers are sliding-window; the global
layers attend the full (sequence-sharded) cache — decode cost is linear."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_pattern=(4096, 0),          # local, global alternating
    sliding_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118",
)

smoke = ModelConfig(
    name="gemma2-27b-smoke",
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
