from repro_torch.data.synthetic import FederatedClassification  # noqa: F401
