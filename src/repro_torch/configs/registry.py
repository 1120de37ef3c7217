"""--arch registry of the port (the archs ported so far)."""
from __future__ import annotations

from typing import Callable, Dict

_LOADERS: Dict[str, Callable] = {}


def _recsys(fn_name: str, kind: str):
    def load():
        from repro_torch.configs import recsys_archs as ra
        return getattr(ra, fn_name)(kind)
    return load


for _base, _fn in [("two-tower-retrieval", "two_tower_bundle"),
                   ("fm", "fm_bundle"), ("dlrm-rm2", "dlrm_bundle"),
                   ("dien", "dien_bundle")]:
    _LOADERS[_base] = _recsys(_fn, "full")
    _LOADERS[_base + "-jpq"] = _recsys(_fn, "jpq")


def list_archs():
    return sorted(_LOADERS)


def get_bundle(name: str):
    if name not in _LOADERS:
        raise KeyError(f"unknown arch {name!r}; ported so far: "
                       f"{list_archs()}")
    return _LOADERS[name]()
