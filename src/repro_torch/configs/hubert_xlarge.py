"""hubert-xlarge [audio]: encoder-only transformer, wav2vec2 arch
[arXiv:2106.07447]. The mel/conv feature extractor is a stub — inputs are
precomputed frame embeddings (B, S, d). Targets are the 504-way cluster
codebook (masked-prediction reduced to full-position CE on synthetic
targets). Encoder-only => NO decode shapes (decode_32k, long_500k skipped,
DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    frontend="audio",
    act="gelu",
    gated_ffn=False,
    source="arXiv:2106.07447",
)

smoke = ModelConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=64,
    is_encoder=True,
    frontend="audio",
    act="gelu",
    gated_ffn=False,
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="skip", has_decode=False,
                notes="encoder-only: decode shapes skipped")
