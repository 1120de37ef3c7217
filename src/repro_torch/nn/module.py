"""Parameter holders: a reference parameter subtree as an ``nn.Module``,
the leaves of a ``params()`` tree, and its size."""
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


def tree_leaves(tree):
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def param_count(tree) -> int:
    """Elements of every tensor in a ``params()`` tree, the uint8/int32
    codes included (the reference's ``nn.param_count``)."""
    return sum(t.numel() for t in tree_leaves(tree))


def param_bytes(tree) -> int:
    """Bytes of every tensor in a ``params()`` tree: elements times
    element size (the reference's ``nn.param_bytes``)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
