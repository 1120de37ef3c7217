"""Parity of the port's training slice with the JAX reference, on the CPU:
the synthetic data and codebooks (array-equal), the optimizer, the
ranking metrics and history schema, the Trainer against the reference's
loss + ``apply_updates`` on identical batches from a bridged init, and
the training CLI.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.core import assign as J_assign
from repro.data import sequences as J_data
from repro.models.sequential import SeqRecConfig as J_Cfg
from repro.models.sequential import SeqRecModel as J_Model
from repro.nn import module as J_nn
from repro.train import metrics as J_met
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import assign as T_assign
from repro_torch.data import sequences as T_data
from repro_torch.launch import train as T_cli
from repro_torch.models.sequential import SeqRecConfig as T_Cfg
from repro_torch.models.sequential import SeqRecModel as T_Model
from repro_torch.train import loop as T_loop
from repro_torch.train import metrics as T_met
from repro_torch.train import optimizer as T_opt

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
DATA = dict(n_users=120, n_items=300, seq_len=16, seed=3)


def _data():
    return (J_data.SyntheticSequences(J_data.SeqDataConfig(**DATA)),
            T_data.SyntheticSequences(T_data.SeqDataConfig(**DATA)))


# ------------------------------------------------------------- data

def test_sequences_array_equal():
    jd, td = _data()
    assert jd.n_users_eff == td.n_users_eff
    for u in (0, 7, jd.n_users_eff - 1):
        np.testing.assert_array_equal(jd.seqs[u], td.seqs[u])
    for step in (0, 5):
        for a, b in ((jd.train_batch(step, 8, n_negatives=2),
                      td.train_batch(step, 8, n_negatives=2)),
                     (jd.twotower_batch(step, 8, 6),
                      td.twotower_batch(step, 8, 6))):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    for split in ("val", "test"):
        a, b = (d.eval_batch(range(0, 40, 3), split=split) for d in (jd, td))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(jd.train_interactions(), td.train_interactions()):
        np.testing.assert_array_equal(a, b)
    assert jd.long_tail_share() == td.long_tail_share()


@pytest.mark.parametrize("strategy", ["random", "svd", "bpr"])
def test_codebooks_array_equal(strategy):
    jd, _ = _data()
    u, i = jd.train_interactions()
    kw = dict(interactions=(u, i + 1), n_users=jd.n_users_eff, seed=5)
    if strategy == "bpr":
        kw["epochs"] = 2
    want = J_assign.build_codebook(strategy, 302, 4, 16, **kw)
    got = T_assign.build_codebook(strategy, 302, 4, 16, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(want, got)


def test_codebook_needs_interactions():
    with pytest.raises(ValueError, match="interactions"):
        T_assign.build_codebook("svd", 10, 2, 4)


# -------------------------------------------------------- optimizer

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    vals = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal(4).astype(np.float32)}],
            "codes": rng.integers(0, 8, (6, 2)).astype(np.uint8)}
    grads = [{"w": rng.standard_normal((5, 3)).astype(np.float32) * s,
              "blocks": [{"b": rng.standard_normal(4).astype(np.float32)}]}
             for s in (0.1, 3.0, 1.0)]
    return vals, grads


@pytest.mark.parametrize("schedule", ["constant", "cosine",
                                      "linear_warmup_cosine"])
@pytest.mark.parametrize("kind", ["adamw", "adam", "sgd"])
def test_apply_updates_matches(kind, schedule):
    """Three updates on identical grads (one above the clip norm), with
    decoupled weight decay: within 2e-6 relative (float32 scalars on
    both sides; pow and sqrt may differ by an ulp)."""
    cfg = dict(kind=kind, lr=0.05, weight_decay=0.1, clip_norm=1.0,
               schedule=schedule, warmup_steps=2, total_steps=5)
    jc, tc = J_opt.OptConfig(**cfg), T_opt.OptConfig(**cfg)
    vals, grads = _opt_trees(0)
    jv = jax.tree.map(jnp.asarray, vals)
    js = J_opt.init_opt_state(jv)
    tv = jax.tree.map(torch.tensor, vals)
    ts = T_opt.init_opt_state(tv)
    for g in grads:
        jg = {**jax.tree.map(jnp.asarray, g),
              "codes": np.zeros((6, 2), jax.dtypes.float0)}
        tg = {**jax.tree.map(torch.tensor, g), "codes": None}
        jv, js, jst = J_opt.apply_updates(jc, js, jv, jg)
        tv, ts, tst = T_opt.apply_updates(tc, ts, tv, tg)
        assert abs(float(jst["lr"]) - float(tst["lr"])) <= 1e-7
        assert abs(float(jst["grad_norm"]) - float(tst["grad_norm"])) \
            <= 1e-6 * float(jst["grad_norm"])
    got = T_opt.tree_map(lambda x: x.numpy(), tv)
    assert jax.tree.structure(got) == jax.tree.structure(jv)
    for a, b in zip(jax.tree.leaves(jv), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=2e-6, atol=1e-7)
    assert tv["codes"].dtype == torch.uint8
    assert ts["m"]["codes"].numel() == 0 and ts["step"] == 3


def test_schedule_lr_matches():
    for sched in ("constant", "cosine", "linear_warmup_cosine"):
        cfg = dict(lr=1e-3, schedule=sched, warmup_steps=10,
                   total_steps=100)
        for step in (0, 1, 5, 10, 50, 100, 150):
            assert float(J_opt.schedule_lr(J_opt.OptConfig(**cfg),
                                           jnp.asarray(step))) == \
                float(T_opt.schedule_lr(T_opt.OptConfig(**cfg), step))


# ---------------------------------------------------------- metrics

def test_ranking_metrics_match():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 5, (40, 30)).astype(np.float32)   # many ties
    t = rng.integers(0, 30, 40)
    for fn in ("rank_of", "ndcg_at_k", "hr_at_k"):
        want = getattr(J_met, fn)(jnp.asarray(s), jnp.asarray(t))
        got = getattr(T_met, fn)(torch.tensor(s), torch.tensor(t))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                                   atol=1e-7)


def test_history_schema_matches():
    assert T_met.HISTORY_SCHEMA == J_met.HISTORY_SCHEMA
    rows = [{"step": 0, "loss": 1.0, "sec": 0.1},
            {"step": 2, "eval_ndcg10": 0.5},
            {"step": 1, "loss": True},
            {"step": 3, "exchange_fraction": 1.5, "sec": -1.0}]
    assert T_met.validate_history(rows) == J_met.validate_history(rows)


# ---------------------------------------------------------- trainer

KW = dict(arch="sasrec", n_items=300, max_len=16, d_model=32, n_layers=2,
          n_heads=2, d_ff=64)


def _bridged(seed=0):
    jd, td = _data()
    u, i = jd.train_interactions()
    codes = J_assign.build_codebook("svd", 302, 4, 16, interactions=(u, i + 1),
                                    n_users=jd.n_users_eff, seed=seed)
    jm = J_Model(J_Cfg(embedding=J_EC(0, 0, kind="jpq", m=4, b=16), **KW),
                 codes=codes)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_Model(T_Cfg(embedding=T_EC(0, 0, kind="jpq", m=4, b=16,
                                      use_kernel=True), **KW),
                 codes=codes, generator=torch.Generator().manual_seed(seed),
                 device="cpu")
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jd, td, jm, jp, tm


def _jax_steps(jm, jp, jd, opt_cfg, steps, B):
    values = J_nn.values(jp)
    state = J_opt.init_opt_state(values)
    losses = []

    def loss_fn(v, batch):
        return jm.train_loss(J_nn.with_values(jp, v), batch)[0]

    grad = jax.jit(jax.value_and_grad(loss_fn, allow_int=True))
    for s in range(steps):
        batch = jax.tree.map(jnp.asarray, jd.train_batch(s, B))
        loss, g = grad(values, batch)
        values, state, _ = J_opt.apply_updates(opt_cfg, state, values, g)
        losses.append(float(loss))
    return values, losses


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_trainer_matches_reference_steps(kind):
    """3 steps on identical batches from a bridged init.  sgd: every
    parameter within 1e-5 of the reference's (drift of fp32 gradient
    noise times the lr); adamw: the loss trajectory within 1e-4
    relative (Adam's normalisation amplifies near-zero gradient noise in
    single parameters, not the loss)."""
    jd, td, jm, jp, tm = _bridged()
    cfg = dict(kind=kind, lr=0.05 if kind == "sgd" else 3e-3)
    jv, jl = _jax_steps(jm, jp, jd, J_opt.OptConfig(**cfg), 3, 8)
    tr = T_loop.Trainer(tm, T_opt.OptConfig(**cfg),
                        T_loop.TrainConfig(steps=3, batch_size=8,
                                           log_every=1, eval_every=0),
                        data_fn=lambda s: td.train_batch(s, 8))
    params, hist = tr.run(params=tm.params())
    tl = [h["loss"] for h in hist if "loss" in h]
    assert tr.done_step == 3 and len(tl) == 3
    np.testing.assert_allclose(jl, tl, rtol=1e-4 if kind == "adamw" else
                               1e-5)
    if kind == "sgd":
        got = T_opt.tree_map(lambda x: x.detach().numpy(), params)
        assert jax.tree.structure(got) == jax.tree.structure(jv)
        for a, b in zip(jax.tree.leaves(jv), jax.tree.leaves(got)):
            np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5)


def test_trainer_eval_and_early_stop():
    """eval rows every eval_every steps; a metric that never improves
    stops the run after `patience` rounds."""
    _, td, _, _, tm = _bridged()
    tr = T_loop.Trainer(
        tm, T_opt.OptConfig(lr=1e-3),
        T_loop.TrainConfig(steps=10, log_every=5, eval_every=2,
                           early_stop_patience=2),
        data_fn=lambda s: td.train_batch(s, 4),
        eval_fn=lambda p: {"ndcg10": 0.5})
    _, hist = tr.run(params=tm.params())
    evals = [h for h in hist if "eval_ndcg10" in h]
    assert [h["step"] for h in evals] == [1, 3, 5]
    assert tr.done_step == 6


@pytest.mark.parametrize("knob", [
    dict(grad_compression="bf16"),
    dict(grad_accum_shards=4), dict(fsdp=True), dict(overlap="backward")])
def test_trainer_unported_options_raise(knob):
    """The elastic knobs are ported: without a mesh the port raises the
    reference's error, word for word (logical-axis rules, which the
    Trainer now takes, change nothing there); on a mesh with a
    ``model`` axis > 1 an elastic spec replicates the model over it
    (item 9c-iii): no blocks, V resolved over the data axis alone."""
    import types

    from repro.train import loop as J_loop
    with pytest.raises(ValueError) as want:
        J_loop.Trainer(None, J_opt.OptConfig(), J_loop.TrainConfig(**knob),
                       data_fn=None)
    with pytest.raises(ValueError) as got:
        T_loop.Trainer(None, T_opt.OptConfig(), T_loop.TrainConfig(**knob),
                       data_fn=None)
    assert str(got.value) == str(want.value)
    model_mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                       rank=0)
    if "overlap" in knob:        # not an elastic spec: the same error
        with pytest.raises(ValueError) as got:
            T_loop.Trainer(None, T_opt.OptConfig(),
                           T_loop.TrainConfig(**knob), data_fn=None,
                           mesh=model_mesh)
        assert str(got.value) == str(want.value)
    else:
        tr = T_loop.Trainer(None, T_opt.OptConfig(),
                            T_loop.TrainConfig(**knob), data_fn=None,
                            mesh=model_mesh)
        assert tr.spec.elastic and not tr._split and tr._world == 1
        assert tr._accum == knob.get("grad_accum_shards", 1)
    with pytest.raises(ValueError) as got:
        T_loop.Trainer(None, T_opt.OptConfig(), T_loop.TrainConfig(**knob),
                       data_fn=None, rules={"embed": ("model",)})
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- CLI

def test_cli_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--n-items", "300", "--d-model", "32",
         "--eval-every", "2", "--batch-size", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "done at step 3 on cpu" in r.stdout
    assert "eval_ndcg10" in r.stdout


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        T_cli.main(["--steps", "1", "--n-items", "50"])


def test_cli_flags_and_defaults_match_the_reference():
    from repro.launch import train as J_cli
    j = vars(J_cli.build_parser().parse_args([]))
    t = vars(T_cli.build_parser().parse_args([]))
    assert t.pop("device") == "cuda"
    assert t.pop("share_card") is False       # ranks sharing one card
    assert t == j


@pytest.mark.parametrize("flags", [["--arch", "qwen3-14b", "--devices", "2"],
                                   ["--arch", "fm", "--mesh", "2",
                                    "--model-axis", "2",
                                    "--grad-compression", "int8"],
                                   ["--arch", "dien", "--model-axis", "2",
                                    "--grad-accum-shards", "4"],
                                   ["--grad-compression", "bf16",
                                    "--model-axis", "2"],
                                   ["--arch", "mace", "--devices", "2"]])
def test_cli_unported_flags_raise(flags, capfd):
    """What the CLI still refuses: MACE on more than one rank (item
    10e; MACE trains on one device, tests/test_torch_mace.py).  An LM
    trains on a mesh (item 10c): qwen3-14b on two data ranks, its loss
    within 1e-5 relative of the single-device CLI's
    (tests/test_torch_lm_mesh.py holds the LMs on every mesh shape).
    The elastic exchange on a ``model`` axis (item 9c-iii) trains, with
    any arch, on two gloo ranks; ``--mesh``, the TrainSpec flags and
    every arch's ``--model-axis`` train too
    (tests/test_torch_elastic.py, tests/test_torch_model_axis_train.py,
    tests/test_torch_ctr_model_axis.py,
    tests/test_torch_elastic_model_axis.py)."""
    common = ["--n-items", "50", "--batch-size", "8", "--eval-every", "0"]
    argv = ["--device", "cpu", "--steps", "1", *common, *flags]
    if "mace" in flags:
        with pytest.raises(NotImplementedError, match="item 10e"):
            T_cli.main(argv)
        return
    if "qwen3-14b" in flags:
        from test_torch_lm_train import cli_losses
        want = cli_losses("qwen3-14b", [], capfd, steps=1)
        got = cli_losses("qwen3-14b", [*common, *flags], capfd, steps=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        return
    assert T_cli.main(argv) is None                 # spawned ranks
    out = capfd.readouterr().out
    assert "done at step 1 on cpu, mesh {'data': 1, 'model': 2}" in out


def test_full_width_config_sizes():
    """The full-width configuration the card trains: 1,000,002 rows."""
    cfg = T_Cfg(arch="sasrec", n_items=1_000_000,
                embedding=T_EC(0, 0, kind="jpq", m=8, b=256,
                               use_kernel=True))
    assert cfg.n_rows == 1_000_002 and cfg.mask_id == 1_000_001
    assert dataclasses.asdict(cfg.emb_cfg())["init_scale"] == 0.02
