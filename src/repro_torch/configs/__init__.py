from repro_torch.configs.base import FedConfig, TrainConfig  # noqa: F401
