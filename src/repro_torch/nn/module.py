"""Parameter holders: a reference parameter subtree as an ``nn.Module``,
the leaves of a ``params()`` tree, its shapes, and its size."""
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


def tree_shapes(tree):
    """The shape of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape)


def meta_tree(shapes):
    """A tree of ``meta`` tensors of those shapes (what
    ``dist.params_shardings`` resolves placements on)."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [meta_tree(v) for v in shapes]
    return torch.empty(shapes, device="meta")


def _whole(spec_tree):
    """A specs tree with every leaf replicated."""
    if isinstance(spec_tree, dict):
        return {k: _whole(v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_whole(v) for v in spec_tree]
    return (None,) * len(spec_tree)


class Placed:
    """The placement of a model's leaves on a ``(data, model)`` mesh, for
    an ``nn.Module`` whose ``param_axes()`` holds the reference's
    logical axes of ``params()``.  ``WHOLE`` names the top-level
    subtrees kept whole by design; ``HOLDERS`` the attribute that holds
    a top-level key of ``params()`` where the two names differ
    (``bridge``).  ``_record_shapes()`` notes the whole leaves' shapes
    once they are drawn."""

    WHOLE: tuple = ()
    HOLDERS: dict = {}

    def _record_shapes(self) -> dict:
        self._whole_shapes = tree_shapes(self.params())
        return self.params()

    def whole_shapes(self) -> dict:
        """The shape of every leaf of ``params()`` before any cut."""
        return self._whole_shapes

    def placement(self, mesh, rules=None) -> dict:
        """The placement spec of every leaf as the port holds it on
        ``mesh``: the reference's ``params_shardings`` of the whole
        leaves (``dist.params_shardings`` of ``param_axes``, the
        divisibility fallback included), less the leaves kept whole by
        design: the RecJPQ centroids (every rank's items reference every
        code, so each rank needs the whole LUT anyway) and the subtrees
        in ``WHOLE`` (GRU weights, whose ``mlp`` split would cost an
        all-reduce a cell step)."""
        from repro_torch import dist
        specs = dist.params_shardings(meta_tree(self._whole_shapes),
                                      self.param_axes(), mesh, rules)
        for sub in specs.values():
            if isinstance(sub, dict) and "centroids" in sub:
                sub["centroids"] = _whole(sub["centroids"])
        for name in self.WHOLE:
            specs[name] = _whole(specs[name])
        return specs


def param_count(tree) -> int:
    """Elements of every tensor in a ``params()`` tree, the uint8/int32
    codes included (the reference's ``nn.param_count``)."""
    return sum(t.numel() for t in tree_leaves(tree))


def param_bytes(tree) -> int:
    """Bytes of every tensor in a ``params()`` tree: elements times
    element size (the reference's ``nn.param_bytes``)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def stack_params(trees: list):
    """Per-layer trees of tensors (dicts, lists) -> one tree whose leaves
    are ``[L, ...]`` stacks: the reference's ``nn.stack_params``, which
    the scanned LM stores its blocks as."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_params([t[i] for t in trees])
                for i in range(len(first))]
    return torch.stack(list(trees))


def unstack_params(tree) -> list:
    """A tree of ``[L, ...]`` stacks -> the L per-layer trees, each leaf
    a view of its layer (``torch.unbind``: the gradients of the L views
    reach the stack in one ``stack``, where slicing the stack layer by
    layer would add an ``[L, ...]`` zero tensor a layer).  Where the
    reference slices the stack inside ``scan``, the port takes layer i
    as ``unstack_params(blocks)[i]``."""
    if isinstance(tree, dict):
        parts = {k: unstack_params(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack_params(v) for v in tree]
        return [[p[i] for p in parts] for i in range(len(parts[0]))]
    return list(torch.unbind(tree, 0))


def hold(tree):
    """A tree of tensors held as modules: a list as a ``ModuleList``, a
    dict as ``Tensors`` of its tensors with its subtrees as child
    modules."""
    if isinstance(tree, list):
        return torch.nn.ModuleList(hold(v) for v in tree)
    mod = Tensors({k: v for k, v in tree.items()
                   if isinstance(v, torch.Tensor)})
    for k, v in tree.items():
        if not isinstance(v, torch.Tensor):
            mod.add_module(k, hold(v))
    return mod


def live(mod):
    """The tree ``hold`` made, of the live parameters and buffers."""
    if isinstance(mod, torch.nn.ModuleList):
        return [live(m) for m in mod]
    return {**mod.live(), **{k: live(m) for k, m in mod.named_children()}}
