"""Carry the reference's weights into the port.

Two sources:
  * the reference's ``nn.values(params)`` tree handed over as numpy
    arrays (nested dicts, lists for layer stacks), and its optimizer
    state (``{"m", "v", "step"}``, ``load_opt_state``);
  * a reference checkpoint's flat ``arrays.npz``, whose keys are the
    tree paths joined by ``/`` (``values/item_emb/centroids``,
    ``values/user_mlp/layers/0/w``, ``opt/m/pos_emb``, ``opt/step``);
    ``unflatten(flat, prefix)`` takes one subtree out of it.
Every leaf must match the port's shape and dtype exactly, so codes and
centroids arrive bit-identical.  The sequential models' trees carry over
(SASRec and BERT4Rec ``pos_emb``/``blocks``/``ln_f``, GRU4Rec
``gru/<i>/{wx, wh, b}`` and ``proj``), with any item table (``full``'s
``table``, ``jpq``'s codes and centroids, ``qr``'s ``q_table`` and
``r_table``), and so do the trees of every ported recsys model: the
two-tower model, FM (``emb``, the ``[V]`` ``linear``, the scalar
``bias``), DLRM (``bot``/``top`` MLPs) and DIEN (``gru1``/``augru``
``wx``/``wh``/``b``, the ``att``/``fc``/``aux`` MLPs, ``tgt_proj``).

On a mesh with a ``"model"`` axis, ``keep_local_rows`` then cuts each
catalogue leaf to this rank's rows (``dist.local_rows``), which the
mesh branches of ``core/sharded.py`` serve from; ``keep_local_blocks``
cuts every leaf a model's placement splits (the catalogue's rows, a
sequential model's heads, the MLPs' widths), which training on
``"model"`` runs from.
"""
from __future__ import annotations

import numpy as np
import torch

_SEP = "/"


def unflatten(flat, prefix: str = "values"):
    """Flat ``/``-joined keys -> nested dicts, integer path parts as
    list indices.  Only keys under ``prefix`` are kept."""
    tree: dict = {}
    for key, arr in flat.items():
        top, *parts = key.split(_SEP)
        if top != prefix or not parts:
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(arr)
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def _copy_tree(dst, src, path: str):
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"{path or '<root>'}: keys {got} != "
                             f"{sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}/{k}")
        return
    if isinstance(dst, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{path}: expected a list of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_tree(d, s, f"{path}/{i}")
        return
    arr = np.asarray(src)
    want = torch.empty((), dtype=dst.dtype).numpy().dtype
    if tuple(arr.shape) != tuple(dst.shape) or arr.dtype != want:
        raise ValueError(f"{path}: {arr.dtype}{tuple(arr.shape)} != "
                         f"{want}{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr, copy=True)))


def load_values(model, values) -> None:
    """Copy a reference values tree into ``model`` (in place)."""
    _copy_tree(model.params(), values, "")
    params = model.params()
    emb = params.get("item_emb", params.get("emb", {}))
    if "codes" in emb and int(emb["codes"].max()) >= model.emb.cfg.b:
        raise ValueError(f"codes must be < b={model.emb.cfg.b}")


def keep_local_rows(model, mesh=None) -> dict:
    """Keep only this rank's rows of each catalogue leaf of ``model``
    (the codes, a full table, FM's ``linear``): every leaf whose first
    logical axis is in ``dist.CATALOGUE_AXES`` and which
    ``dist.params_shardings`` places on ``"model"`` is replaced, in
    place, by its ``dist.local_rows``, so the whole catalogue is not
    held once per rank.  ``mesh`` defaults to the ambient one.  Returns
    the placement specs of ``model.params()`` (before the cut)."""
    from repro_torch import dist as _dist
    from repro_torch.dist import rules as _rules
    mesh = _rules._CTX.mesh if mesh is None else mesh
    axes = model.param_axes()
    specs = _dist.params_shardings(model.params(), axes, mesh)
    for path, spec in _paths(specs):
        ax = _at(axes, path)
        if not ax or ax[0] not in _dist.CATALOGUE_AXES:
            continue
        owner, name = _owner(model, path)
        old = getattr(owner, name)
        _replace(owner, name, old, _dist.local_rows(old.detach(), spec, mesh))
    return specs


def _replace(owner, name, old, new) -> None:
    """Hold ``new`` in place of the leaf ``old`` (a parameter or a
    buffer of ``owner``) where its shape differs."""
    if new.shape == old.shape:
        return
    if name in owner._parameters:
        owner._parameters[name] = torch.nn.Parameter(
            new, requires_grad=old.requires_grad)
    else:
        owner._buffers[name] = new


def keep_local_blocks(model, mesh=None, rules=None) -> dict:
    """Keep only this rank's block of every leaf of ``model`` that its
    placement (``model.placement(mesh, rules)``: the reference's
    ``params_shardings`` less the leaves the port keeps whole) puts on
    ``"model"``, in place (``dist.local_block``): the catalogue's rows,
    the attention heads, the MLP's width.  A reference checkpoint or
    ``nn.values()`` tree loaded with ``load_values`` first leaves each
    rank with exactly its blocks.  A leaf already cut is left as it is.
    ``mesh`` defaults to the ambient one.  Returns the placement specs
    of ``model.params()``."""
    from repro_torch import dist as _dist
    from repro_torch.dist import rules as _rules
    mesh = _rules._CTX.mesh if mesh is None else mesh
    specs = model.placement(mesh, rules)
    whole = model.whole_shapes()
    for path, spec in _paths(specs):
        owner, name = _owner(model, path)
        old = getattr(owner, name)
        full = tuple(_at(whole, path))
        if tuple(old.shape) != full:
            if tuple(old.shape) != _dist.block_shape(full, spec, mesh):
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{tuple(old.shape)} is neither the whole "
                                 f"{full} nor this rank's block of it")
            continue
        _replace(owner, name, old, _dist.local_block(old.detach(), spec,
                                                     mesh))
    return specs


def _paths(tree, path=()):
    """(path, leaf) of a tree of dicts and lists; a tuple is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _owner(model, path):
    """(module, attribute name) holding the leaf at ``path`` of
    ``model.params()``.  A model's ``HOLDERS`` names the attribute that
    holds a top-level key where the two differ (FM's ``emb`` in
    ``emb_table``, its ``linear`` and ``bias`` in ``head``); a tower's
    ``layers`` key is its ``ModuleList`` itself."""
    holders = getattr(model, "HOLDERS", {})
    mod, keys = model, list(path[:-1])
    if path[0] in holders:
        mod, keys = getattr(model, holders[path[0]]), keys[1:]
    for k in keys:
        if isinstance(mod, torch.nn.ModuleList) and k == "layers":
            continue
        mod = mod[k] if isinstance(mod, (torch.nn.ModuleList,
                                         torch.nn.ModuleDict)) \
            else getattr(mod, k)
    return mod, path[-1]


def load_opt_state(opt_state, src) -> dict:
    """Copy a reference optimizer state (``{"m", "v", "step"}`` of numpy
    leaves, e.g. ``unflatten(flat, "opt")``) into the port's
    ``init_opt_state`` tree, in place, leaf for leaf (the codes' empty
    moment slots included); returns it with ``step`` an int."""
    for slot in ("m", "v"):
        _copy_tree(opt_state[slot], src[slot], f"opt/{slot}")
    return {**opt_state, "step": int(np.asarray(src["step"]))}


def load_npz(model, path, prefix: str = "values") -> None:
    """Copy a reference checkpoint's ``arrays.npz`` into ``model``."""
    with np.load(path) as z:
        load_values(model, unflatten({k: z[k] for k in z.files}, prefix))
