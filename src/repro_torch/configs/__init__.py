from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ExperimentConfig,
    FedConfig,
    MeshConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    MTPConfig,
    RGLRUConfig,
    ShapeConfig,
    TrainConfig,
    XLSTMConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    ArchSpec,
    all_archs,
    get_arch,
)
