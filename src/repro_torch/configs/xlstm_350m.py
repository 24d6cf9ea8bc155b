"""xlstm-350m [ssm]: alternating mLSTM (matrix memory) / sLSTM blocks
[arXiv:2405.04517]. long_500k native: decode state is O(1). sLSTM core is
replicated over the model axis (4-head block-diag recurrence, DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.configs.registry import ArchSpec

config = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    xlstm=XLSTMConfig(pattern=("mlstm", "slstm"), mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0),
    source="arXiv:2405.04517",
)

smoke = ModelConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    block_pattern=("mlstm", "slstm"),
    xlstm=XLSTMConfig(),
    dtype="float32",
)

SPEC = ArchSpec(model=config, smoke=smoke, long_500k="native",
                notes="sLSTM core replicated over model axis; long_500k native")
