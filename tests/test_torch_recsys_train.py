"""Training parity of the port's CTR and two-tower models
(repro_torch.models.recsys ``train_loss``, ``init_params``,
``train/loop.Trainer`` and ``launch/train``'s CTR branch) with the JAX
reference, on the CPU, for all eight bundles at their smoke configs.

The reference's smoke models are initialised by the reference, their
``nn.values()`` trees bridged into the port's models, and both take the
same numpy template batch.  Tolerances (fp32; the port sums in another
order than XLA, and FM's linear term and the full two-tower user tower
run through the embedding_bag kernels' plain versions):
- ``train_loss``: the loss, and DIEN's ``main`` and ``aux``, within 1e-5
  relative; ``in_batch_acc`` and ``auc_proxy`` equal (measured: losses
  at most 1.7e-7 relative apart);
- gradients (the Trainer's ``autograd.grad``) against ``jax.grad`` of
  the reference's loss: every float leaf within 1e-5 of its largest
  entry, or within 1e-6 of the largest entry of the whole gradient,
  whichever is larger.  The floor is for leaves whose fp32 gradient is
  a sum that cancels, where no summation order gets within 1e-5 of the
  leaf's own largest entry: the two-tower's last user-tower bias over
  the batch of 4 (the reference's and the port's gradients each lie
  9.8e-6 of the leaf's largest entry from the float64 gradient, 1.05e-5
  from each other) and DIEN's attention output bias (a softmax is
  shift-invariant: its exact gradient is 0, both sides are rounding
  noise of ~3e-11).  Measured: every other leaf within 5.4e-6 of its
  largest entry; every leaf within 3.2e-7 of the gradient's largest
  entry;
- three adamw steps of ``Trainer`` against three reference steps
  (``jax.grad`` + ``train/optimizer.apply_updates``) from the same
  bridged start: the losses within 1e-5 relative (measured: at most
  8.9e-8).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as J_bundle
from repro.configs import registry as J_registry
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch.configs import get_bundle as T_bundle
from repro_torch.configs import list_archs
from repro_torch.nn.module import tree_leaves
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt
from repro_torch.train.spec import accumulate_grads

ARCHS = ["two-tower-retrieval", "two-tower-retrieval-jpq", "fm", "fm-jpq",
         "dlrm-rm2", "dlrm-rm2-jpq", "dien", "dien-jpq"]
METRICS = {"two-tower": ("loss", "in_batch_acc"), "fm": ("loss", "auc_proxy"),
           "dlrm": ("loss",), "dien": ("loss", "main", "aux")}
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _metric_keys(name):
    return next(v for k, v in METRICS.items() if name.startswith(k))


def _fresh(name):
    """(reference model, its params, the port's model on the bridged
    values, the numpy template batch)."""
    jm, batch, rng = J_bundle(name).make_smoke()
    jp = jm.init_params(rng)
    tm, _ = T_bundle(name).make_smoke(device="cpu", seed=1)
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jm, jp, tm, {k: np.array(v) for k, v in batch.items()}


_PAIRS = {}


def _pair(name):
    """``_fresh(name)``, cached; read only."""
    if name not in _PAIRS:
        _PAIRS[name] = _fresh(name)
    return _PAIRS[name]


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _pairs_by_path(tp, jt, path=""):
    """(path, port leaf, reference leaf) of two trees of one structure,
    matched by key (``jax.tree.leaves`` orders dict keys otherwise)."""
    if isinstance(tp, dict):
        assert set(tp) == set(jt), path
        for k in tp:
            yield from _pairs_by_path(tp[k], jt[k], f"{path}/{k}")
    elif isinstance(tp, (list, tuple)):
        assert len(tp) == len(jt), path
        for i, (a, b) in enumerate(zip(tp, jt)):
            yield from _pairs_by_path(a, b, f"{path}/{i}")
    else:
        yield path, tp, jt


def _port_grads(tm, batch):
    """The plain step's gradients of the loss on ``batch`` (its
    ``autograd.grad`` over the float leaves of ``params()``), as a tree
    shaped like ``params()`` (None at the codes), and its metrics."""
    params = tm.params()
    floats = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
    for x in floats:
        x.requires_grad_(True)
    _, got, mets = accumulate_grads(
        tm.train_loss, 1, params, _t(batch),
        lambda i: T_loop.step_generator(0, 0, tm.device, i), floats,
        has_aux=True)
    by_id = {id(x): g for x, g in zip(floats, got)}
    return T_opt.tree_map(lambda x: by_id.get(id(x)), params), mets


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_matches_reference(name):
    jm, jp, tm, batch = _pair(name)
    jl, jmets = jm.train_loss(jp, _jnp(batch))
    tl, tmets = tm.train_loss(tm.params(), batch)
    assert set(tmets) == set(_metric_keys(name)) == set(jmets)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    for k in tmets:
        want, got = float(jmets[k]), float(tmets[k])
        if k in ("in_batch_acc", "auc_proxy"):
            assert got == want, k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=k)
    assert np.isfinite(float(tl))


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_match_jax_grad(name):
    jm, jp, tm, batch = _pair(name)
    values = J_nn.values(jp)

    def loss_fn(v):
        return jm.train_loss(J_nn.with_values(jp, v), _jnp(batch))[0]

    jg = jax.grad(loss_fn, allow_int=True)(values)
    tg, mets = _port_grads(tm, batch)
    np.testing.assert_allclose(float(mets["loss"].detach()),
                               float(loss_fn(values)), rtol=1e-5, atol=0)
    leaves = []
    for path, got, want in _pairs_by_path(tg, jg):
        if got is None:                       # the frozen codes
            assert "codes" in path
            continue
        want = np.asarray(want)
        assert got.shape == want.shape, path
        assert np.abs(want).max() > 0, f"{path}: no gradient reached it"
        leaves.append((path, got.numpy(), want))
    assert len(leaves) >= 3
    floor = 1e-6 * max(float(np.abs(w).max()) for _, _, w in leaves)
    for path, got, want in leaves:
        tol = max(1e-5 * float(np.abs(want).max()), floor)
        assert np.abs(got - want).max() <= tol, path


@pytest.mark.parametrize("name", ARCHS)
def test_three_adamw_steps_match_reference(name):
    """Three adamw steps (lr 3e-3) on the template batch from one
    bridged start: the port's ``Trainer`` against the reference's
    ``jax.grad`` + ``apply_updates``."""
    jm, jp, tm, batch = _fresh(name)
    values = J_nn.values(jp)
    state = J_opt.init_opt_state(values)
    jb = _jnp(batch)

    def loss_fn(v):
        return jm.train_loss(J_nn.with_values(jp, v), jb)[0]

    grad = jax.value_and_grad(loss_fn, allow_int=True)
    want = []
    for _ in range(3):
        loss, g = grad(values)
        values, state, _ = J_opt.apply_updates(J_opt.OptConfig(lr=3e-3),
                                               state, values, g)
        want.append(float(loss))
    tr = T_loop.Trainer(tm, T_opt.OptConfig(lr=3e-3),
                        T_loop.TrainConfig(steps=3, log_every=1,
                                           eval_every=0),
                        data_fn=lambda s: batch)
    params, hist = tr.run(params=tm.params())
    got = [h["loss"] for h in hist if "loss" in h]
    assert tr.done_step == 3 and len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # the leaves come back as they were handed over: detached
    assert not any(x.requires_grad for x in tree_leaves(params))


def test_init_params_redraws_in_the_constructors_order():
    """``init_params(generator)`` redraws every parameter in place as
    the constructor drew it, and returns ``params()``."""
    for name in ARCHS:
        b = T_bundle(name)
        a, _ = b.make_smoke(device="cpu", seed=3)
        m, _ = b.make_smoke(device="cpu", seed=4)
        got = m.init_params(torch.Generator().manual_seed(3))
        want = a.params()
        for (_, x, y) in _pairs_by_path(got, want):
            assert torch.equal(x, y), name
        for (_, x, y) in _pairs_by_path(m.params(), want):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("name", ["fm", "two-tower-retrieval"])
def test_kernel_path_tables_get_their_gradient_through_embedding_bag(
        name, monkeypatch):
    """FM's ``linear`` and the full two-tower table take their gradient
    from the embedding_bag backward (the plain version on the CPU)."""
    from repro_torch.kernels.embedding_bag import ref as bag_ref
    calls = []
    real = bag_ref.embedding_bag_backward_ref

    def spy(ids, weights, dout, V):
        calls.append((tuple(ids.shape), V, tuple(dout.shape)))
        return real(ids, weights, dout, V)

    monkeypatch.setattr(bag_ref, "embedding_bag_backward_ref", spy)
    _, _, tm, batch = _pair(name)
    _port_grads(tm, batch)
    if name == "fm":
        assert calls == [(batch["sparse"].shape, sum(tm.cfg.vocabs()),
                          (batch["sparse"].shape[0], 1))]
    else:
        rows = tm.params()["item_emb"]["table"].shape[0]
        assert calls == [(batch["user_hist"].shape, rows,
                          (batch["user_hist"].shape[0], tm.cfg.embed_dim))]


# ============================================================ launch/train

@pytest.mark.parametrize("name", ARCHS)
def test_cli_trains_each_ctr_arch_on_cpu(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", name, "--steps", "3"], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"arch {name}: training the reduced smoke config" in r.stdout
    assert "done at step 3 on cpu" in r.stdout
    losses = [float(ln.split("'loss': ")[1].split(",")[0])
              for ln in r.stdout.splitlines() if "'loss': " in ln]
    assert len(losses) == 3 and np.all(np.isfinite(losses))


def test_cli_microbatches_and_checkpoints_for_a_ctr_arch(tmp_path):
    """``--microbatches`` and ``--ckpt-dir`` work for a CTR arch: a
    2-step run saves, the rerun to 4 steps resumes from step 2."""
    from repro_torch.launch import train as T_train
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--arch", "dien-jpq", "--microbatches", "2",
            "--ckpt-dir", d, "--ckpt-every", "1"]
    h1 = T_train.main(argv + ["--steps", "2"])
    h2 = T_train.main(argv + ["--steps", "4"])
    assert [h["step"] for h in h1 if "loss" in h] == [0, 1]
    assert [h["step"] for h in h2 if "loss" in h] == [2, 3]
    assert all(np.isfinite(h["loss"]) for h in h1 + h2)


def test_cli_refuses_an_unported_arch():
    """Every arch of the reference's registry is ported (MACE since item
    10b, tests/test_torch_mace.py), so the CLI refuses only a name
    neither registry knows."""
    from repro_torch.launch import train as T_train
    unported = [a for a in J_registry.list_archs() if a not in list_archs()]
    assert unported == []
    args = T_train.build_parser().parse_args(["--device", "cpu", "--arch",
                                              "no-such-arch"])
    with pytest.raises(KeyError, match="unknown arch"):
        T_train.build(args)


def test_cli_without_a_card_raises():
    from repro_torch.launch import train as T_train
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    args = T_train.build_parser().parse_args(["--arch", "fm"])
    with pytest.raises(RuntimeError, match="cuda"):
        T_train.build(args)
