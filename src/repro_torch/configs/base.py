"""Arch bundles: what an ``--arch`` name resolves to."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class ArchBundle:
    """``make_model(device, seed)`` builds the full-width model;
    ``make_smoke(device, seed)`` a small one plus a request template
    (a dict of numpy arrays), as ``(model, batch)``."""
    name: str
    family: str                          # recsys (more with later slices)
    make_model: Callable[..., Any]
    make_smoke: Callable[..., tuple]
    description: str = ""
