"""--arch registry of the port: the five LM archs (family ``"lm"``),
the eight recsys bundles (the CTR and two-tower archs, full and
``-jpq``) and ``mace`` (family ``"gnn"``): every arch of the
reference's registry."""
from __future__ import annotations

from typing import Callable, Dict

_LOADERS: Dict[str, Callable] = {}


def _lm(module: str):
    def load():
        import importlib
        return importlib.import_module(
            f"repro_torch.configs.{module}").bundle()
    return load


_LM_MODULES = {"mixtral-8x7b": "mixtral_8x7b", "olmoe-1b-7b": "olmoe_1b_7b",
               "stablelm-12b": "stablelm_12b", "qwen3-14b": "qwen3_14b",
               "stablelm-1.6b": "stablelm_1_6b"}
LM_ARCHS = tuple(_LM_MODULES)
for _name, _mod in _LM_MODULES.items():
    _LOADERS[_name] = _lm(_mod)


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


def _mace():
    from repro_torch.configs import mace_arch
    return mace_arch.bundle()


_LOADERS["mace"] = _mace


# the 10 assigned archs (the 40-cell dry-run grid), and the paper's
# technique at production scale beside them
ARCHS = ["mixtral-8x7b", "olmoe-1b-7b", "stablelm-12b", "qwen3-14b",
         "stablelm-1.6b", "mace", "two-tower-retrieval", "fm",
         "dlrm-rm2", "dien"]
JPQ_VARIANTS = ["two-tower-retrieval-jpq", "fm-jpq", "dlrm-rm2-jpq",
                "dien-jpq"]


def list_archs():
    return sorted(_LOADERS)


def get_bundle(name: str):
    if name not in _LOADERS:
        raise KeyError(f"unknown arch {name!r}; ported so far: "
                       f"{list_archs()}")
    return _LOADERS[name]()
