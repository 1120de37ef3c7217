from repro_torch.configs.registry import (ARCHS, JPQ_VARIANTS,  # noqa: F401
                                         get_bundle, list_archs)
