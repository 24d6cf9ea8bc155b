from repro_torch.data.synthetic import (  # noqa: F401
    FederatedClassification,
    FederatedLMData,
)
