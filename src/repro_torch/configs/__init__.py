from repro_torch.configs.registry import get_bundle, list_archs  # noqa: F401
