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
The LM's tree carries over too (``models/lm.py``): ``tok_emb`` (a
``table``, or RecJPQ ``codes``/``centroids``), ``blocks`` as ``[L, ...]``
stacks or a list of layers, each with ``ln1``, ``ln2``,
``attn.{wq,wk,wv,wo[,q_norm,k_norm]}`` and ``mlp.{wi_gate,wi_up,wo}``
or ``moe.{router,wi_gate,wi_up,wo}``, then ``ln_f`` and ``lm_head``;
``load_caches`` carries its KV caches (``k``, ``v``, ``pos``), so a
stream decoded by the reference goes on in the port from any position.
MACE's tree carries over too (``models/mace.py``): ``embed`` (``w``,
``b``), ``layers`` as a list, each with ``radial.p<l1><l2><l3>.w`` a
path, ``mix_a``, ``msg`` and ``res`` ``.l<l>`` an irrep order and
``prod_w.o<order>_p<l1><l2><l3>``, then the ``readout`` MLP.

On a mesh with a ``"model"`` axis, ``keep_local_rows`` then cuts each
catalogue leaf to this rank's rows (``dist.local_rows``), which the
mesh branches of ``core/sharded.py`` serve from; ``keep_local_blocks``
cuts every leaf a model's placement splits (the catalogue's rows, a
sequential model's heads, the MLPs' widths; an LM's heads, experts and
vocabulary, its stacked ``[L, ...]`` blocks on their second or later
dimension), which training on ``"model"`` runs from.  ``load_values``
of a whole reference tree into a model already cut copies each rank's
blocks.
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


def _copy_tree(dst, src, path: str, specs=None, mesh=None):
    """Copy ``src`` into ``dst`` leaf for leaf.  ``specs``: the placement
    tree of ``dst`` on ``mesh``; a leaf that ``dst`` holds as this rank's
    block takes the block of the whole value (``dist.local_block``)."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"{path or '<root>'}: keys {got} != "
                             f"{sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}/{k}",
                       None if specs is None else specs[k], mesh)
        return
    if isinstance(dst, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{path}: expected a list of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_tree(d, s, f"{path}/{i}",
                       None if specs is None else specs[i], mesh)
        return
    arr = np.asarray(src)
    if dst.dtype == torch.bfloat16:       # numpy has no bf16: its raw bits
        want, ok = "bfloat16", arr.dtype.name == "bfloat16"
        if ok:
            arr = arr.view(np.uint16)
    else:
        want = torch.empty((), dtype=dst.dtype).numpy().dtype
        ok = arr.dtype == want
    if ok:
        t = torch.from_numpy(np.array(arr, copy=True)).view(dst.dtype)
        if specs is not None and t.shape != dst.shape:
            from repro_torch import dist as _dist
            t = _dist.local_block(t, specs, mesh, copy=False)
    if not ok or t.shape != dst.shape:
        raise ValueError(f"{path}: {np.asarray(src).dtype}"
                         f"{tuple(arr.shape)} != {want}{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def load_values(model, values, mesh=None) -> None:
    """Copy a reference values tree into ``model`` (in place).  Where a
    leaf of ``model`` holds this rank's block of the whole leaf
    (``keep_local_blocks`` ran first), the block of the whole value is
    copied into it (``mesh``: default the ambient one)."""
    from repro_torch.dist import rules as _rules
    mesh = _rules._CTX.mesh if mesh is None else mesh
    held = model.params()
    cut = mesh is not None and hasattr(model, "placement") and any(
        tuple(x.shape) != tuple(_at(model.whole_shapes(), q))
        for q, x in _paths(held))
    _copy_tree(held, values, "", model.placement(mesh) if cut else None,
               mesh)
    params = model.params()
    emb = next((params[k] for k in ("item_emb", "emb", "tok_emb")
                if k in params), {})
    if "codes" in emb and int(emb["codes"].max()) >= model.emb.cfg.b:
        raise ValueError(f"codes must be < b={model.emb.cfg.b}")


def load_caches(caches, src) -> dict:
    """Copy the reference's KV caches (``TransformerLM.init_caches``'
    tree after any number of decode steps: ``k``, ``v`` [L, B, C, Hkv,
    Dh] in their dtype, bf16 included, and ``pos`` [L] int32) into the
    port's ``init_caches`` tree of the same shapes, in place; returns
    it."""
    _copy_tree(caches, src, "caches")
    return caches


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
