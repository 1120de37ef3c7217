"""Parameter holders: a reference parameter subtree as an ``nn.Module``."""
from __future__ import annotations

import torch


class Tensors(torch.nn.Module):
    """One parameter subtree: floating tensors are parameters, integer
    ones (the codes) buffers."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            if t.is_floating_point():
                self.register_parameter(name, torch.nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    def tensors(self) -> dict:
        out = {n: p.detach() for n, p in self.named_parameters(recurse=False)}
        out.update(self.named_buffers(recurse=False))
        return out

    def live(self) -> dict:
        """The parameters themselves (not detached), for training, and the
        buffers."""
        out = dict(self.named_parameters(recurse=False))
        out.update(self.named_buffers(recurse=False))
        return out
