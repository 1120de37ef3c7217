"""The decoder-only LMs on a ``(data, model)`` mesh (``TransformerLM``'s
``placement``, the head-, expert- and vocab-parallel layers, the
vocab-parallel cross-entropy on bf16 logits, the Trainer, its
checkpoints, ``prefill`` / ``decode_step`` with the KV cache split over
``kv_heads``, and ``launch/train.py --arch <lm> --model-axis S``)
against the JAX reference, on the CPU.

The port's meshes are gloo processes started by
``repro_torch.launch.mesh.spawn``, each shape spawned once (1x2, 1x4,
2x2), every rank running every case.  The reference runs on one device
in this process: its own LM fails in its first step on any mesh under
jax 0.9.0 (ROADMAP.md queue 3), so the anchor is its single-device
``train_loss`` and ``jax.grad`` on the whole batch.  For an MoE arch at
D = 2 the reference's ``dist.data_shard_count`` is patched to return 2
for the call (``pytest.MonkeyPatch.context``), so it dispatches two
groups, each of one data rank's rows, as its mesh run would.

Cases: the five LM bundles' smoke configs (fp32), stablelm-smoke and
olmoe-smoke with a RecJPQ vocabulary (m 4, b 16, vocab 504, which 2
and 4 divide, so the codes split and the loss is the vocab-parallel
one), qwen3-smoke with a full table of 504 rows (the table's rows and
``lm_head``'s columns split) and mixtral-smoke with its blocks as a list
(``scan_layers`` off).  The smoke vocabulary of 503 divides neither 2
nor 4, so there the vocabulary stays whole.

Held (the leaf rule of tests/test_torch_recsys_train.py: each gradient
leaf within 1e-5 of its largest entry, or 1e-6 of the gradient's
largest, whichever is larger):
  * every leaf's placement on (1, 2), (1, 4) and (2, 2) is the
    reference's ``resolve_axes`` of its axes, the centroids whole, and
    the blocks kept are those slices (stacked and listed blocks; a whole
    reference tree loaded into a cut model lands on the same blocks);
  * ``gated_mlp``, ``attention`` (mixtral-smoke's GQA, whose two kv
    heads stay whole at S = 4; qwen3-smoke's qk-norm with ``q_chunk``;
    a window with ``q_chunk``) and ``moe_apply`` (8 experts split at S
    = 2 and 4; 6 experts, split at S = 2 and over their width at S = 4;
    drops at capacity_factor 0.5), each against the reference's function
    with ``groups`` = D: the output within 1e-5 of its largest, the aux
    loss within 1e-5 relative, ``jax.grad`` of the input and of every
    leaf by the leaf rule;
  * one step of each case at each shape: the loss, ``ce`` and ``aux``
    within 1e-5 relative, every gathered gradient leaf by the leaf rule
    (the gradient taken on another thread, outside the mesh's context,
    as autograd runs a CUDA backward: the remat recompute carries it);
  * the vocab-parallel cross-entropy on bf16 logits: the loss within
    1e-6 relative of the reference's fp32-lse / bf16-picked loss, the
    bf16 gradient within 2^-7 of its largest entry;
  * three Trainer steps (olmoe-smoke, qwen3-smoke at 504) at each
    shape: the losses within 1e-5 relative of the reference's three
    adamw steps; at (1, 2) bit-identical run to run, the checkpoint
    read by the reference's ``restore_checkpoint`` (whole leaves under
    its keys), and a resume from step 2 bit-equal to the run;
  * ``prefill`` and 12 ``decode_step``s at (1, 2) and (1, 4) (mixtral's
    8-slot ring wraps): logits within 1e-5 of the largest of the
    reference's, each rank's cache its block of the reference's cache
    within the same bound;
  * ``launch/train.py --arch qwen3-14b --model-axis 2``, and ``--devices
    4 --model-axis 2`` for olmoe-1b-7b and qwen3-14b (olmoe at
    ``--model-axis 2`` is tests/test_torch_lm_train.py's): the losses
    within 1e-5 relative of the single-device CLI's.
"""
import contextlib
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dist as J_dist
from repro.ckpt import restore_checkpoint as J_restore
from repro.ckpt import save_checkpoint as J_save
from repro.configs import get_bundle as J_bundle
from repro.core import EmbeddingConfig as J_EC
from repro.dist import resolve_axes as J_resolve
from repro.models.lm import TransformerLM as J_LM
from repro.nn import attention as J_attn
from repro.nn import layers as J_layers
from repro.nn import module as J_nn
from repro.nn import moe as J_moe
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch import dist as T_dist
from repro_torch.configs import get_bundle as T_bundle
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import sharded as T_sharded
from repro_torch.launch import mesh as M
from repro_torch.launch import train as T_cli
from repro_torch.models.lm import TransformerLM as T_LM
from repro_torch.nn import attention as T_attn
from repro_torch.nn import layers as T_layers
from repro_torch.nn import moe as T_moe
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt
from test_torch_lm_train import cli_losses, reference_steps

SHAPES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SPAWN_TIMEOUT = 300
LEAF, FLOOR = 1e-5, 1e-6
# case -> (arch, variant)
CASES = {"mixtral-8x7b": ("mixtral-8x7b", None),
         "olmoe-1b-7b": ("olmoe-1b-7b", None),
         "stablelm-12b": ("stablelm-12b", None),
         "qwen3-14b": ("qwen3-14b", None),
         "stablelm-1.6b": ("stablelm-1.6b", None),
         "stablelm-1.6b-jpq": ("stablelm-1.6b", "jpq"),
         "olmoe-1b-7b-jpq": ("olmoe-1b-7b", "jpq"),
         "qwen3-14b-v504": ("qwen3-14b", "v504"),
         "mixtral-8x7b-list": ("mixtral-8x7b", "list")}
TRAIN_CASES = ("olmoe-1b-7b", "qwen3-14b-v504")
SERVE_CASES = ("mixtral-8x7b", "olmoe-1b-7b", "stablelm-12b", "qwen3-14b",
               "stablelm-1.6b", "olmoe-1b-7b-jpq", "qwen3-14b-v504")
V504, STEPS, DECODE = 504, 3, 12
OPT = dict(lr=3e-3)
# layer -> (kind, config kwargs, input shape)
ATTN = dict(d_model=64, n_heads=4, head_dim=16)
LAYERS = {
    "mlp": ("mlp", dict(d_model=16, d_ff=32), (2, 6, 16)),
    "attn-gqa-window": ("attn", dict(ATTN, n_kv=2, window=8,
                                     rope_theta=1e6), (2, 16, 64)),
    "attn-qknorm-qchunk": ("attn", dict(ATTN, n_kv=2, qk_norm=True,
                                        q_chunk=4), (2, 16, 64)),
    "attn-window-qchunk": ("attn", dict(ATTN, n_kv=4, window=6, q_chunk=4),
                           (2, 16, 64)),
    "moe-8": ("moe", dict(n_experts=8, top_k=4, d_model=16, d_ff=32),
              (32, 16)),
    "moe-6": ("moe", dict(n_experts=6, top_k=2, d_model=16, d_ff=32),
              (32, 16)),
    "moe-drops": ("moe", dict(n_experts=8, top_k=2, d_model=16, d_ff=32,
                              capacity_factor=0.5), (32, 16)),
}


# ------------------------------------------------------------- configs

_BASE = {}


def _cfgs(case):
    """(reference config, port config) of ``case``."""
    arch, var = CASES[case]
    if arch not in _BASE:
        _BASE[arch] = (J_bundle(arch).make_smoke()[0].cfg,
                       T_bundle(arch).make_smoke(device="cpu")[0].cfg)
    jc, tc = _BASE[arch]
    if var == "jpq":
        return (dataclasses.replace(jc, vocab=V504, embedding=J_EC(
                    0, 0, kind="jpq", m=4, b=16)),
                dataclasses.replace(tc, vocab=V504, embedding=T_EC(
                    0, 0, kind="jpq", m=4, b=16, use_kernel=True)))
    if var == "v504":
        return (dataclasses.replace(jc, vocab=V504),
                dataclasses.replace(tc, vocab=V504))
    if var == "list":
        return (dataclasses.replace(jc, scan_layers=False),
                dataclasses.replace(tc, scan_layers=False))
    return jc, tc


def _codes(case):
    if CASES[case][1] != "jpq":
        return None
    return np.random.default_rng(1).integers(0, 16, (V504, 4)).astype(
        np.int32)


def _j_model(case):
    return J_LM(_cfgs(case)[0], codes=_codes(case))


def _t_model(case, values=None):
    tm = T_LM(_cfgs(case)[1], codes=_codes(case), device="cpu",
              generator=torch.Generator().manual_seed(0))
    if values is not None:
        bridge.load_values(tm, values)
    return tm


def _batch(case, seed):
    """B 2 x S 16 tokens and targets over the case's vocabulary (seed 0
    at vocab 503: the bundles' smoke batch)."""
    V = _cfgs(case)[0].vocab
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, V, (2, 16)),
            "targets": r.integers(0, V, (2, 16))}


def _values(jm, seed=0):
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jp, jax.tree.map(np.asarray, J_nn.values(jp))


def _is_moe(case):
    return _cfgs(case)[0].moe is not None


def _rows(batch, d, D):
    n = len(batch["tokens"]) // D
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


# ----------------------------------------------------------- the worker
# (module-level, so spawned processes import it by name)

def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _key(path):
    return "/".join(map(str, path))


def _tb(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _whole(tree, specs, mesh):
    sp = dict(_paths(specs))
    return {_key(p): T_dist.gather_block(x.detach(), sp[p], mesh).numpy()
            for p, x in _paths(tree)}


def _one_step(mesh, case, values, batch):
    """(loss, ce, aux, {path: whole gradient}): this rank's data rows
    through the split model over the whole batch's counts, the data
    group's sum, the blocks gathered."""
    D = mesh.shape["data"]
    tm = _t_model(case, values)
    specs = bridge.keep_local_blocks(tm, mesh)
    p = tm.params()
    fn = T_loop.counted_loss(tm, mesh) if D > 1 else tm.train_loss
    with T_dist.use_mesh_rules(mesh, local_batch=D > 1):
        loss, mets = fn(p, _tb(_rows(batch, mesh.data_index, D)))
    floats = [x for _, x in _paths(p) if torch.is_floating_point(x)]
    got = iter(_grad_elsewhere(loss, floats))
    grads = {q: next(got) for q, x in _paths(p)
             if torch.is_floating_point(x)}
    flat = T_loop.sum_over_ranks([loss.detach(), mets["ce"], mets["aux"]]
                                 + list(grads.values()), mesh)
    sp = dict(_paths(specs))
    return ([float(x) for x in flat[:3]],
            {_key(q): T_dist.gather_block(g, sp[q], mesh).numpy()
             for q, g in zip(grads, flat[3:])})


def _grad_elsewhere(loss, leaves):
    """``torch.autograd.grad`` on another thread, outside the ambient
    mesh: where autograd runs a CUDA backward (its own thread), so the
    remat blocks' recompute must carry the mesh it ran under."""
    out = {}

    def run():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves)
        except Exception as e:          # re-raised on the caller's thread
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


def _layer(mesh, name, values, axes, x, dy):
    """A layer of ``LAYERS`` on this rank's blocks of ``values`` (placed
    by ``resolve_axes`` of the reference's ``axes``): (output, aux or
    None, {leaf: whole gradient}, gradient of the input)."""
    kind, kw, _ = LAYERS[name]
    specs = {k: T_dist.resolve_axes(axes[k], values[k].shape, mesh)
             for k in values}
    p = {k: T_dist.local_block(torch.as_tensor(values[k]), specs[k], mesh)
         .requires_grad_(True) for k in values}
    xt = torch.as_tensor(x).requires_grad_(True)
    aux = None
    with T_dist.use_mesh_rules(mesh):
        if kind == "mlp":
            y = T_layers.gated_mlp(p, xt, d_ff=kw["d_ff"])
        elif kind == "attn":
            tp = dict(p)
            for nm in ("q_norm", "k_norm"):
                if nm in tp:
                    tp[nm] = {"scale": tp.pop(nm)}
            y = T_attn.attention(tp, T_attn.AttnConfig(**kw), xt)
        else:
            y, aux = T_moe.moe_apply(p, T_moe.MoEConfig(**kw), xt)
        loss = torch.sum(y * torch.as_tensor(dy))
        if aux is not None:
            loss = loss + aux
        grads = torch.autograd.grad(loss, [xt] + list(p.values()))
    return (y.detach().numpy(), None if aux is None else float(aux),
            {k: T_dist.gather_block(g, specs[k], mesh).numpy()
             for k, g in zip(p, grads[1:])}, grads[0].numpy())


def _trainer(mesh, case, values, batches, ckpt_dir=None, steps=STEPS):
    tm = _t_model(case, values)
    tr = T_loop.Trainer(tm, T_opt.OptConfig(**OPT), T_loop.TrainConfig(
        steps=steps, batch_size=2, log_every=1, eval_every=0,
        ckpt_dir=ckpt_dir, ckpt_every=2), data_fn=lambda s: batches[s],
        mesh=mesh)
    params, hist = tr.run(params=tm.params())
    rows = [h for h in hist if "loss" in h]
    return ([h["loss"] for h in rows], _whole(params, tr._specs, mesh))


def _xent_bf16(mesh, inp):
    """The vocab-parallel cross-entropy's mean on this rank's column
    block of the shared bf16 logits, and its gathered gradient."""
    logits = torch.as_tensor(inp["xent_logits"]).bfloat16()
    labels = torch.as_tensor(inp["xent_labels"])
    N = logits.shape[-1]
    with T_dist.use_mesh_rules(mesh):
        lo, hi = T_dist.row_block(N)
        leaf = logits[..., lo:hi].clone().requires_grad_(True)
        ce = T_sharded.vocab_parallel_xent(leaf, labels, lo, mesh)
        assert ce.dtype == torch.float32
        loss = torch.mean(ce)
        (g,) = torch.autograd.grad(loss, leaf)
    return float(loss), mesh.all_gather(g, "model", 2).float().numpy()


def _serve(mesh, case, values, toks):
    """(prefill's logits, each decode step's logits, this rank's caches)
    on this rank's blocks."""
    tm = _t_model(case, values)
    bridge.keep_local_blocks(tm, mesh)
    p = tm.params()
    tt = torch.as_tensor(toks)
    B, S = toks.shape
    with T_dist.use_mesh_rules(mesh), torch.no_grad():
        pre = tm.prefill(p, tt).numpy()
        caches = tm.init_caches(B, S, torch.float32)
        steps = [tm.decode_step(p, tt[:, t:t + 1], caches)[0].numpy()
                 for t in range(DECODE)]
    return pre, steps, {k: v.numpy() for k, v in caches.items()}


def _worker(mesh, inp_path, out_path):
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    D, S = mesh.shape["data"], mesh.shape["model"]
    out = {}
    for case in CASES:
        values, batch = inp["one"][case]
        out[case] = _one_step(mesh, case, values, batch)
    for name in LAYERS:
        out[("layer", name)] = _layer(mesh, name, *inp["layers"][name])
    for case in TRAIN_CASES:
        values, batches = inp["three"][case]
        out[("three", case)] = _trainer(mesh, case, values, batches)[0]
    out["xent"] = _xent_bf16(mesh, inp)
    if (D, S) == (1, 2):
        case = TRAIN_CASES[0]
        values, batches = inp["three"][case]
        first = _trainer(mesh, case, values, batches)
        again = _trainer(mesh, case, values, batches)
        out["bitwise"] = (again[0] == first[0] and all(
            np.array_equal(again[1][k], first[1][k]) for k in first[1]))
        ck = inp["ckpt_dirs"]
        out["uninterrupted"] = _trainer(mesh, case, values, batches,
                                        ckpt_dir=ck["A"], steps=4)
        _trainer(mesh, case, values, batches, ckpt_dir=ck["B"], steps=2)
        out["resumed"] = _trainer(mesh, case, values, batches,
                                  ckpt_dir=ck["B"], steps=4)
    mine = {}
    if D == 1:
        for case in SERVE_CASES:
            values, toks = inp["serve"][case]
            mine[case] = _serve(mesh, case, values, toks)
    torch.save(mine, f"{out_path}.rank{mesh.rank}")
    if mesh.rank == 0:
        torch.save(out, out_path)


# ------------------------------------------------------------ fixtures

def _axes(tree):
    if isinstance(tree, dict):
        return {k: _axes(v) for k, v in tree.items()}
    return tree.axes


def _flat_layer(tree):
    """A layer's P tree as flat {name: value}, {name: axes} (the qk-norm
    scales under their own names)."""
    vals, axes = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = v["scale"]
        vals[k], axes[k] = np.asarray(v.value), v.axes
    return vals, axes


def _layer_params(name):
    kind, kw, _ = LAYERS[name]
    kg = J_nn.KeyGen(11)
    if kind == "mlp":
        return J_layers.gated_mlp_init(kg, kw["d_model"], kw["d_ff"])
    if kind == "attn":
        return J_attn.attention_init(kg, J_attn.AttnConfig(**kw))
    return J_moe.moe_init(kg, J_moe.MoEConfig(**kw))


def _inputs(root):
    inp = {"one": {}, "three": {}, "serve": {}, "layers": {}}
    for case in CASES:
        jm = _j_model(case)
        inp["one"][case] = (_values(jm)[1], _batch(case, 0))
    for case in TRAIN_CASES:
        jm = _j_model(case)
        inp["three"][case] = (_values(jm)[1],
                              [_batch(case, 10 + s) for s in range(4)])
    for case in SERVE_CASES:
        inp["serve"][case] = (inp["one"][case][0], _batch(case, 5)["tokens"])
    rng = np.random.default_rng(3)
    for name, (_, _, shape) in LAYERS.items():
        vals, axes = _flat_layer(_layer_params(name))
        x = rng.standard_normal(shape).astype(np.float32)
        dy = rng.standard_normal(shape).astype(np.float32)
        inp["layers"][name] = (vals, axes, x, dy)
    T, N = 16, 64
    inp["xent_logits"] = (4 * rng.standard_normal((2, T // 2, N))).astype(
        np.float32)
    labels = rng.integers(0, N, (2, T // 2))
    labels[0, :4] = [0, N // 4, N // 2, N - 1]          # on every rank
    inp["xent_labels"] = labels
    inp["ckpt_dirs"] = {k: os.path.join(root, "ckpt", k) for k in "AB"}
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh shape's results, each spawned once."""
    root = tmp_path_factory.mktemp("lm_mesh")
    inp = _inputs(str(root))
    path = str(root / "inputs.pt")
    torch.save(inp, path)
    out = {}
    for name, (D, S) in SHAPES.items():
        res = str(root / f"{name}.pt")
        M.spawn(_worker, D * S, (path, res), model=S, timeout=SPAWN_TIMEOUT)
        out[name] = torch.load(res, weights_only=False)
        out[name]["ranks"] = [torch.load(f"{res}.rank{r}", weights_only=False)
                              for r in range(D * S)]
    out["inputs"] = inp
    return out


# ---------------------------------------------------------- the reference

@contextlib.contextmanager
def _groups_of(D):
    """The reference's dispatch groups at D data ranks, for a call."""
    with pytest.MonkeyPatch.context() as mp:
        if D > 1:
            mp.setattr(J_dist, "data_shard_count", lambda: D)
        yield


def _j_flat(g):
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(g):
        if x.dtype == jax.dtypes.float0:
            continue
        out["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)] = np.asarray(x)
    return out


def _j_step(case, values, batch, D):
    """The reference's (loss, ce, aux) and gradient of one step over the
    whole batch, at D dispatch groups for an MoE arch."""
    jm = _j_model(case)
    jp, _ = _values(jm)
    jb = jax.tree.map(jnp.asarray, batch)

    def loss(v):
        out, mets = jm.train_loss(J_nn.with_values(jp, v), jb)
        return out, mets
    with _groups_of(D if _is_moe(case) else 1):
        (val, mets), g = jax.value_and_grad(loss, has_aux=True,
                                            allow_int=True)(
            jax.tree.map(jnp.asarray, values))
    return ([float(val), float(mets["ce"]), float(mets["aux"])],
            _j_flat(g))


@pytest.fixture(scope="module")
def ref_cache():
    return {}


def _ref(cache, key, fn, *args):
    if key not in cache:
        cache[key] = fn(*args)
    return cache[key]


def _j_three(case, values, batches, D):
    jm = _j_model(case)
    jp, _ = _values(jm)
    cfg = J_opt.OptConfig(**OPT)
    v = jax.tree.map(jnp.asarray, values)
    st = J_opt.init_opt_state(v)
    losses = []
    with _groups_of(D if _is_moe(case) else 1):
        for s in range(STEPS):
            jb = jax.tree.map(jnp.asarray, batches[s])
            val, g = jax.value_and_grad(lambda vv: jm.train_loss(
                J_nn.with_values(jp, vv), jb)[0], allow_int=True)(v)
            g = jax.tree.map(lambda a, x: jnp.zeros_like(x)
                             if a.dtype == jax.dtypes.float0 else a, g, v)
            v, st, _ = J_opt.apply_updates(cfg, st, v, g)
            losses.append(float(val))
    return losses


def _j_layer(name, D):
    kind, kw, _ = LAYERS[name]
    meta = _layer_params(name)

    def fn(vals, x):
        p = J_nn.with_values(meta, vals)
        aux = None
        if kind == "mlp":
            y = J_layers.gated_mlp(p, x)
        elif kind == "attn":
            y = J_attn.attention(p, J_attn.AttnConfig(**kw), x)
        else:
            y, aux = J_moe.moe_apply(p, J_moe.MoEConfig(**kw), x, groups=D)
        return y, aux
    return meta, fn


def _rule(want, got):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(want) == set(got), sorted(set(want) ^ set(got))
    for k in want:
        err = float(np.abs(want[k] - got[k]).max())
        assert err <= max(LEAF * float(np.abs(want[k]).max()),
                          FLOOR * top), (k, err)


def _rel(got, want, tol=1e-5):
    assert abs(got - want) <= tol * abs(want), (got, want)


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_placement_is_the_references(shape, case):
    """Every leaf placed by the reference's ``resolve_axes`` of its
    axes, the centroids whole; ``keep_local_blocks`` keeps those slices
    (stacked blocks on the dimension after ``"layers"``), and loading
    the whole reference tree into the cut model lands on them too."""
    import types
    jm = _j_model(case)
    meta = jm.init_params(jax.random.PRNGKey(0))
    D, S = SHAPES[shape]
    jmesh = types.SimpleNamespace(shape={"data": D, "model": S})
    values = jax.tree.map(np.asarray, J_nn.values(meta))
    tm = _t_model(case, values)
    whole = {_key(p): x.detach().clone() for p, x in _paths(tm.params())}
    mesh = M.HostMesh(D, S, rank=S - 1)
    got = dict(_paths(tm.placement(mesh)))
    n_split = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            meta, is_leaf=J_nn.is_param):
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        ref = tuple(J_resolve(leaf.axes, leaf.value.shape, jmesh))
        if key[-1] == "centroids":
            assert got[key] == (None,) * len(ref), key
        else:
            assert got[key] == ref, key
            n_split += "model" in ref
    assert n_split >= 5
    bridge.keep_local_blocks(tm, mesh)
    for path, x in _paths(tm.params()):
        assert torch.equal(x, T_dist.local_block(whole[_key(path)],
                                                 got[path], mesh)), path
    fresh = _t_model(case)
    bridge.keep_local_blocks(fresh, mesh)
    bridge.load_values(fresh, values, mesh)
    for (path, a), (_, b) in zip(_paths(fresh.params()),
                                 _paths(tm.params())):
        assert torch.equal(a, b), path
    blocks = tm.params()["blocks"]
    attn = (blocks[0] if isinstance(blocks, list) else blocks)["attn"]
    stacked = not isinstance(blocks, list)
    assert attn["wq"].shape[1 + stacked] == 4 // S


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_reference(runs, ref_cache, shape, name):
    D, S = SHAPES[shape]
    vals, _, x, dy = runs["inputs"]["layers"][name]
    meta, fn = _j_layer(name, D)
    jvals = J_nn.values(meta)

    def loss(v, xx):
        y, aux = fn(v, xx)
        out = jnp.sum(y * dy)
        return (out + aux if aux is not None else out), (y, aux)

    def ref():
        (_, (y, aux)), (gv, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(jvals, jnp.asarray(x))
        flat = {}
        for k, v in gv.items():
            flat[k] = np.asarray(v["scale"] if isinstance(v, dict) else v)
        return (np.asarray(y), None if aux is None else float(aux), flat,
                np.asarray(gx))
    wy, waux, wg, wgx = _ref(ref_cache, ("layer", name, D), ref)
    y, aux, g, gx = runs[shape][("layer", name)]
    assert np.abs(y - wy).max() <= LEAF * np.abs(wy).max()
    if waux is not None:
        _rel(aux, waux)
    _rule({**wg, "x": wgx}, {**g, "x": gx})
    if name == "moe-6":
        held = T_dist.resolve_axes(("expert", "embed", "mlp"), (6, 16, 32),
                                   M.HostMesh(D, S))
        assert held == (("model", None, None) if S == 2 else
                        (None, None, "model"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_one_step_matches_reference(runs, ref_cache, shape, case):
    D, _ = SHAPES[shape]
    values, batch = runs["inputs"]["one"][case]
    groups = D if _is_moe(case) else 1
    (wl, wce, waux), want = _ref(ref_cache, ("one", case, groups), _j_step,
                                 case, values, batch, groups)
    (loss, ce, aux), got = runs[shape][case]
    _rel(loss, wl)
    _rel(ce, wce)
    _rel(aux, waux)
    if _is_moe(case):
        assert waux > 0
    _rule(want, got)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_vocab_parallel_xent_bf16_matches_reference(runs, shape):
    inp = runs["inputs"]
    labels = jnp.asarray(inp["xent_labels"])

    def loss(lg):
        lse = jax.nn.logsumexp(lg.astype(jnp.float32), -1)
        picked = jnp.take_along_axis(lg, labels[..., None], -1)[..., 0]
        return jnp.mean(lse - picked.astype(jnp.float32))
    lg = jnp.asarray(inp["xent_logits"]).astype(jnp.bfloat16)
    want, g = jax.value_and_grad(loss)(lg)
    got, gg = runs[shape]["xent"]
    _rel(got, float(want), 1e-6)
    g = np.asarray(g.astype(jnp.float32))
    assert np.abs(gg - g).max() <= 2.0 ** -7 * np.abs(g).max()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_three_trainer_steps_match_reference(runs, ref_cache, shape, case):
    D, _ = SHAPES[shape]
    values, batches = runs["inputs"]["three"][case]
    groups = D if _is_moe(case) else 1
    want = _ref(ref_cache, ("three", case, groups), _j_three, case, values,
                batches, groups)
    got = runs[shape][("three", case)]
    assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)


def test_run_to_run_bitwise_and_resume(runs):
    out = runs["1x2"]
    assert out["bitwise"] is True
    l1, w1 = out["uninterrupted"]
    l2, w2 = out["resumed"]
    assert l2 == l1[2:]
    for k in w1:
        assert np.array_equal(w1[k], w2[k]), k


def test_checkpoint_holds_whole_leaves_the_reference_reads(runs):
    inp = runs["inputs"]
    values, _ = inp["three"][TRAIN_CASES[0]]
    jv = jax.tree.map(jnp.asarray, values)
    like = {"values": jv, "opt": J_opt.init_opt_state(jv)}
    tree, step = J_restore(inp["ckpt_dirs"]["A"], like)
    assert step == 4
    _, whole = runs["1x2"]["uninterrupted"]
    for k, x in _j_flat(tree["values"]).items():
        assert np.array_equal(x, whole[k]), k
    m = _j_flat(tree["opt"]["m"])
    assert m["blocks/moe/wi_gate"].shape == values["blocks"]["moe"][
        "wi_gate"].shape


def _close(got, want, tol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
@pytest.mark.parametrize("case", SERVE_CASES)
def test_prefill_and_decode_match_reference(runs, ref_cache, shape, case):
    values, toks = runs["inputs"]["serve"][case]
    _, S = SHAPES[shape]

    def ref():
        jm = _j_model(case)
        jp, _ = _values(jm)
        pre = np.asarray(jm.prefill(jp, jnp.asarray(toks)))
        jc = jm.init_caches(toks.shape[0], toks.shape[1], jnp.float32)
        step = jax.jit(jm.decode_step)
        outs = []
        for t in range(DECODE):
            lg, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            outs.append(np.asarray(lg))
        return pre, outs, {k: np.asarray(v) for k, v in jc.items()}
    wpre, wsteps, wc = _ref(ref_cache, ("serve", case), ref)
    n_kv = _cfgs(case)[0].n_kv
    for r, rank in enumerate(runs[shape]["ranks"]):
        pre, steps, caches = rank[case]
        _close(pre, wpre)
        for a, b in zip(steps, wsteps):
            _close(a, b)
        assert np.array_equal(caches["pos"], wc["pos"])
        for k in ("k", "v"):
            block = wc[k]
            if n_kv % S == 0:
                n = n_kv // S
                block = block[:, :, :, r * n:(r + 1) * n]
            _close(caches[k], block)


@pytest.mark.parametrize("arch, flags", [
    ("qwen3-14b", ["--model-axis", "2"]),
    ("qwen3-14b", ["--devices", "4", "--model-axis", "2"]),
    ("olmoe-1b-7b", ["--devices", "4", "--model-axis", "2"])])
def test_cli_trains_an_lm_on_a_mesh(arch, flags, capfd, tmp_path):
    """The CLI's two steps on a mesh within 1e-5 relative of the
    single-device CLI's; for the MoE at D = 2, whose data ranks dispatch
    their tokens as two groups where one device dispatches one (the
    capacities differ, and at the smoke config so do the drops), of the
    reference's two steps at two groups from its smoke weights, which
    the CLI resumes from."""
    D, _ = T_cli.mesh_dims(T_cli.build_parser().parse_args(flags))
    if _cfgs(arch)[0].moe is not None and D > 1:
        start, want = reference_steps(arch, groups=D)
        d = str(tmp_path / "ck")
        J_save(d, {"values": start, "opt": J_opt.init_opt_state(start)}, 0)
        flags = [*flags, "--ckpt-dir", d]
    else:
        want = cli_losses(arch, [], capfd)
    got = cli_losses(arch, flags, capfd)
    assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)
