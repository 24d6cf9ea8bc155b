from repro_torch.configs.base import FedConfig  # noqa: F401
