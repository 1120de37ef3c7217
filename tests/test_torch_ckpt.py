"""The port's checkpoints (repro_torch.ckpt), microbatching and SIGTERM
preemption (repro_torch.train.loop) against the JAX reference, on the
CPU.

* Checkpoints are the reference's format: a reference checkpoint
  (values, optimizer state, early-stop state) restores into the port bit
  for bit, and the port's into the reference; plus the format's
  contracts (exotic dtypes, keep-N GC, partial directories ignored,
  missing keys with and without ``strict``, shape mismatches, async
  saves in order, a failed write raised once).
* ``microbatches=2``: one step against the reference's microbatch step on
  the same batch (loss within 1e-5 relative, sgd values within 1e-5),
  and bit-equal to the single step when both slices are the same rows.
* Preemption: a real SIGTERM at a step, then resume, gives parameters
  bit-equal to the uninterrupted run (dropout on: the masks are a
  function of (seed, step)); the checkpoint is stamped at the step
  reached; the early-stop state survives; the train CLI round-trips.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as J_restore
from repro.ckpt import save_checkpoint as J_save
from repro.core import EmbeddingConfig as J_EC
from repro.data import sequences as J_data
from repro.models.sequential import SeqRecConfig as J_Cfg
from repro.models.sequential import SeqRecModel as J_Model
from repro.nn import module as J_nn
from repro.train import loop as J_loop
from repro.train import optimizer as J_opt
from repro_torch import bridge
from repro_torch import ckpt as T_ckpt
from repro_torch.ckpt import checkpoint as T_ck_mod
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.data import sequences as T_data
from repro_torch.launch import train as T_cli
from repro_torch.models.sequential import SeqRecConfig as T_Cfg
from repro_torch.models.sequential import SeqRecModel as T_Model
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt
from repro_torch.train.spec import accumulate_grads

DATA = dict(n_users=60, n_items=80, seq_len=8, seed=2)
KW = dict(arch="sasrec", n_items=80, max_len=8, d_model=16, n_layers=1,
          n_heads=2, d_ff=32)


def _data():
    return (J_data.SyntheticSequences(J_data.SeqDataConfig(**DATA)),
            T_data.SyntheticSequences(T_data.SeqDataConfig(**DATA)))


def _codes():
    return np.random.default_rng(0).integers(0, 16, (82, 4)).astype(np.int32)


def _pair(**cfg):
    kw = dict(KW, **cfg)
    jm = J_Model(J_Cfg(embedding=J_EC(0, 0, kind="jpq", m=4, b=16), **kw),
                 codes=_codes())
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = T_Model(T_Cfg(embedding=T_EC(0, 0, kind="jpq", m=4, b=16,
                                      use_kernel=True), **kw),
                 codes=_codes(), generator=torch.Generator().manual_seed(0),
                 device="cpu")
    bridge.load_values(tm, jax.tree.map(np.asarray, J_nn.values(jp)))
    return jm, jp, tm


def _port(dropout=0.0, seed=0):
    return T_Model(T_Cfg(embedding=T_EC(0, 0, kind="jpq", m=4, b=16,
                                        use_kernel=True), dropout=dropout,
                         **KW),
                   codes=_codes(), generator=torch.Generator().manual_seed(
                       seed), device="cpu")


def _np_tree(tree):
    return T_opt.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree)


def _assert_bitwise(a, b):
    fa, fb = T_ck_mod.flatten(a), T_ck_mod.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k].view(np.uint8) if fa[k].ndim
                                      else fa[k], fb[k].view(np.uint8)
                                      if fb[k].ndim else fb[k], err_msg=k)


def _ref_state(jm, jp, jd, steps=2):
    """The reference's (values, opt) after ``steps`` adamw steps."""
    values = J_nn.values(jp)
    state = J_opt.init_opt_state(values)

    def loss_fn(v, b):
        return jm.train_loss(J_nn.with_values(jp, v), b)[0]

    grad = jax.grad(loss_fn, allow_int=True)
    for s in range(steps):
        g = grad(values, jax.tree.map(jnp.asarray, jd.train_batch(s, 4)))
        values, state, _ = J_opt.apply_updates(J_opt.OptConfig(), state,
                                               values, g)
    return values, state


# ====================================================== either package

class TestCrossPackage:
    def test_reference_checkpoint_restores_into_port(self, tmp_path):
        jd, td = _data()
        jm, jp, tm = _pair()
        values, state = _ref_state(jm, jp, jd)
        J_save(str(tmp_path), {"values": values, "opt": state,
                               "early_stop": {"best": np.float64(0.25),
                                              "stale": np.int64(1)}}, 2)
        # the Trainer's restore: values in place, opt, early stop, step
        tr = T_loop.Trainer(tm, T_opt.OptConfig(), T_loop.TrainConfig(
            steps=2, ckpt_dir=str(tmp_path)), data_fn=None)
        p = tm.params()
        opt, step, best, stale = tr._restore(p, T_opt.init_opt_state(p))
        assert (step, best, stale) == (2, 0.25, 1)
        assert opt["step"] == 2 and isinstance(opt["step"], int)
        want = jax.tree.map(np.asarray, {"values": values,
                                         "opt": {**state, "step": 0}})
        _assert_bitwise({"values": _np_tree(p),
                         "opt": {**_np_tree(opt), "step": 0}}, want)
        # and through the bridge, from the npz itself
        fresh = _port(seed=5)
        path = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
        bridge.load_npz(fresh, path)
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        opt2 = bridge.load_opt_state(T_opt.init_opt_state(fresh.params()),
                                     bridge.unflatten(flat, "opt"))
        _assert_bitwise({"values": _np_tree(fresh.params()),
                         "opt": {**_np_tree(opt2), "step": 0}}, want)
        assert opt2["step"] == 2

    def test_port_checkpoint_restores_into_reference(self, tmp_path):
        jd, td = _data()
        jm, jp, tm = _pair()
        tr = T_loop.Trainer(tm, T_opt.OptConfig(), T_loop.TrainConfig(
            steps=3, ckpt_dir=str(tmp_path), log_every=1, eval_every=0),
            data_fn=lambda s: td.train_batch(s, 4))
        params, _ = tr.run(params=tm.params())
        values = J_nn.values(jp)
        like = {"values": values, "opt": J_opt.init_opt_state(values),
                "early_stop": {"best": np.float64(1.0),
                               "stale": np.int64(9)}}
        got, step = J_restore(str(tmp_path), like)
        assert step == 3
        assert int(got["opt"]["step"]) == 3
        assert got["opt"]["step"].dtype == np.int32
        assert float(got["early_stop"]["best"]) == -np.inf
        assert int(got["early_stop"]["stale"]) == 0
        _assert_bitwise(jax.tree.map(np.asarray, got["values"]),
                        _np_tree(params))


# ============================================================= format

class TestFormat:
    def _tree(self):
        return {"a": {"w": torch.arange(6.0).reshape(2, 3),
                      "codes": torch.arange(4, dtype=torch.uint8)},
                "b": [torch.ones(3, dtype=torch.float16),
                      torch.zeros((), dtype=torch.int32),
                      torch.tensor([True, False])],
                "bf": torch.linspace(-2, 2, 5).to(torch.bfloat16),
                "n": np.arange(3, dtype=np.int64), "s": 7, "f": 0.5}

    def test_roundtrip_exotic_dtypes(self, tmp_path):
        t = self._tree()
        T_ckpt.save_checkpoint(str(tmp_path), t, 7)
        like = T_opt.tree_map(
            lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
            else (np.zeros_like(x) if isinstance(x, np.ndarray)
                  else type(x)(0)), t)
        got, step = T_ckpt.restore_checkpoint(str(tmp_path), like)
        assert step == 7 and got["s"] == 7 and got["f"] == 0.5
        assert isinstance(got["s"], int)
        for k in ("a", "b", "bf", "n"):
            _assert_bitwise({k: got[k]}, {k: t[k]})
        assert got["bf"].dtype == torch.bfloat16
        assert got["b"][2].dtype == torch.bool

    def test_bfloat16_crosses_packages(self, tmp_path):
        x = torch.linspace(-3, 3, 7).to(torch.bfloat16)
        T_ckpt.save_checkpoint(str(tmp_path / "p"), {"bf": x}, 1)
        got, _ = J_restore(str(tmp_path / "p"), {"bf": jnp.zeros(7,
                                                                jnp.bfloat16)})
        np.testing.assert_array_equal(np.asarray(got["bf"], np.float32),
                                      x.float().numpy())
        J_save(str(tmp_path / "j"), {"bf": jnp.asarray(x.float().numpy(),
                                                       jnp.bfloat16)}, 1)
        back, _ = T_ckpt.restore_checkpoint(
            str(tmp_path / "j"), {"bf": torch.zeros(7, dtype=torch.bfloat16)})
        assert torch.equal(back["bf"], x)

    def test_restored_leaves_take_the_target_dtype_and_device(self,
                                                              tmp_path):
        T_ckpt.save_checkpoint(str(tmp_path), {"w": np.arange(4.0)}, 1)
        got, _ = T_ckpt.restore_checkpoint(
            str(tmp_path), {"w": torch.zeros(4, dtype=torch.float32,
                                             device="cpu")})
        assert got["w"].dtype == torch.float32
        assert got["w"].device == torch.device("cpu")
        assert got["w"].tolist() == [0.0, 1.0, 2.0, 3.0]

    def test_keep_n_gc(self, tmp_path):
        for s in range(5):
            T_ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(2)}, s,
                                   keep=2)
        assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                                "step_0000000004"]

    def test_partial_directories_ignored(self, tmp_path):
        T_ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(2)}, 3)
        os.makedirs(tmp_path / "step_0000000009")          # no manifest
        os.makedirs(tmp_path / ".tmp-abandoned")
        assert T_ckpt.latest_step(str(tmp_path)) == 3
        assert T_ckpt.latest_step(str(tmp_path / "absent")) is None
        got, step = T_ckpt.restore_checkpoint(str(tmp_path),
                                              {"w": torch.zeros(2)})
        assert step == 3 and got["w"].tolist() == [1.0, 1.0]

    def test_missing_keys_strict_and_not(self, tmp_path):
        T_ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(2)}, 1)
        with pytest.raises(KeyError, match="other"):
            T_ckpt.restore_checkpoint(str(tmp_path), {"other": torch.ones(2)})
        got, _ = T_ckpt.restore_checkpoint(
            str(tmp_path), {"w": torch.zeros(2), "err": torch.full((3,), 7.)},
            strict=False)
        assert got["w"].tolist() == [1, 1] and got["err"].tolist() == [7] * 3

    def test_shape_mismatch_raises(self, tmp_path):
        T_ckpt.save_checkpoint(str(tmp_path), {"e": torch.zeros(8, 4)}, 1)
        with pytest.raises(ValueError, match="shape"):
            T_ckpt.restore_checkpoint(str(tmp_path), {"e": torch.zeros(4, 4)})
        with pytest.raises(FileNotFoundError):
            T_ckpt.restore_checkpoint(str(tmp_path / "none"), {})

    def test_metadata(self, tmp_path):
        assert T_ckpt.checkpoint_metadata(str(tmp_path)) == {}
        T_ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(1)}, 4,
                               metadata={"note": "x"})
        assert T_ckpt.checkpoint_metadata(str(tmp_path)) == {"note": "x"}


class TestAsync:
    def test_save_while_a_save_is_in_flight(self, tmp_path, monkeypatch):
        orig = T_ck_mod.save_checkpoint
        calls = []

        def slow_save(directory, tree, step, **kw):
            calls.append(("start", step))
            if step == 1:
                time.sleep(0.3)
            out = orig(directory, tree, step, **kw)
            calls.append(("end", step))
            return out

        monkeypatch.setattr(T_ck_mod, "save_checkpoint", slow_save)
        ck = T_ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
        w = torch.ones(2)
        ck.save({"w": w}, 1)
        w.add_(1.0)                 # the host copy was taken at save()
        ck.save({"w": w}, 2)        # waits for 1 first
        ck.wait()
        assert calls == [("start", 1), ("end", 1), ("start", 2),
                         ("end", 2)]
        one, _ = T_ckpt.restore_checkpoint(str(tmp_path),
                                           {"w": torch.zeros(2)}, step=1)
        assert one["w"].tolist() == [1.0, 1.0]

    def test_failed_write_raises_once_then_recovers(self, tmp_path):
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("a file where the checkpoint directory goes")
        ck = T_ckpt.AsyncCheckpointer(str(blocker), keep=2)
        ck.save({"w": torch.ones(2)}, 1)
        with pytest.raises(OSError):
            ck.wait()
        ck.wait()                   # consumed: no raise
        ck.save({"w": torch.ones(2)}, 2)
        with pytest.raises(OSError):
            ck.wait()
        good = T_ckpt.AsyncCheckpointer(str(tmp_path / "ok"), keep=2)
        good.save({"w": torch.ones(2)}, 3)
        good.wait()
        assert T_ckpt.latest_step(str(tmp_path / "ok")) == 3


# ======================================================= microbatching

class TestMicrobatches:
    def test_step_matches_reference_microbatch_step(self):
        jd, td = _data()
        jm, jp, tm = _pair()
        batch = jd.train_batch(0, 8)
        opt = dict(kind="sgd", lr=0.05)
        jtr = J_loop.Trainer(jm, J_opt.OptConfig(**opt),
                             J_loop.TrainConfig(steps=1, microbatches=2),
                             data_fn=None)
        values = J_nn.values(jp)
        step_fn = jax.jit(jtr._build_step(jp))
        jv, _, jmets = step_fn(values, J_opt.init_opt_state(values),
                               jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(0))
        tr = T_loop.Trainer(tm, T_opt.OptConfig(**opt),
                            T_loop.TrainConfig(steps=1, microbatches=2,
                                               log_every=1, eval_every=0),
                            data_fn=lambda s: td.train_batch(s, 8))
        params, hist = tr.run(params=tm.params())
        assert abs(hist[0]["loss"] - float(jmets["loss"])) <= \
            1e-5 * abs(float(jmets["loss"]))
        got = _np_tree(params)
        for a, b in zip(jax.tree.leaves(jv), jax.tree.leaves(got)):
            np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("kind", ["sgd", "adamw"])
    def test_two_equal_slices_equal_the_single_step(self, kind):
        """Slices that are the same rows give each slice the single
        step's gradient exactly, so (g + g) / 2 == g and the microbatched
        step is bit-equal to the single step on those rows."""
        _, td = _data()
        half = td.train_batch(0, 4)
        both = {k: np.concatenate([v, v]) for k, v in half.items()}
        out = {}
        for n, b in ((1, half), (2, both)):
            tm = _port()
            tr = T_loop.Trainer(tm, T_opt.OptConfig(kind=kind, lr=1e-2),
                                T_loop.TrainConfig(steps=2, microbatches=n,
                                                   log_every=1, eval_every=0),
                                data_fn=lambda s, b=b: b)
            params, hist = tr.run(params=tm.params())
            out[n] = (_np_tree(params), [h["loss"] for h in hist])
        _assert_bitwise(out[1][0], out[2][0])
        assert out[1][1] == out[2][1]

    def test_distinct_halves_equal_the_mean_of_their_single_steps(self):
        """microbatches=2 on [a; b] against its definition, the mean of
        the single steps on a and on b (loss 1e-5 relative, gradients
        1e-4 of their largest entry).  b keeps only its last 3 positions,
        so the halves hold unequal label counts and the single step on
        [a; b] differs from that mean."""
        _, td = _data()
        ab = td.train_batch(0, 8)
        for v in ab.values():
            v[4:, :-3] = 0
        tm = _port()
        p = tm.params()
        floats = list(tm.parameters())

        def step(n, b):
            _, g, mets = accumulate_grads(
                tm.train_loss, n, p, {k: torch.as_tensor(v)
                                      for k, v in b.items()},
                lambda i: T_loop.step_generator(0, 0, "cpu", i), floats,
                has_aux=True)
            return float(mets["loss"]), g

        lm, gm = step(2, ab)
        la, ga = step(1, {k: v[:4] for k, v in ab.items()})
        lb, gb = step(1, {k: v[4:] for k, v in ab.items()})
        lw, _ = step(1, ab)
        want = (la + lb) / 2
        assert abs(lm - want) <= 1e-5 * abs(want)
        assert abs(lw - want) > 1e-5 * abs(want)
        for x, y, z in zip(gm, ga, gb):
            ref = (y + z) / 2
            assert float((x - ref).abs().max()) <= \
                1e-4 * float(ref.abs().max())

    def test_slices_must_be_equal(self):
        _, td = _data()
        tm = _port()
        tr = T_loop.Trainer(tm, T_opt.OptConfig(),
                            T_loop.TrainConfig(steps=1, microbatches=3),
                            data_fn=lambda s: td.train_batch(s, 8))
        with pytest.raises(ValueError, match="equal slices"):
            tr.run(params=tm.params())
        with pytest.raises(ValueError, match=">= 1"):
            T_loop.Trainer(tm, T_opt.OptConfig(),
                           T_loop.TrainConfig(microbatches=0), data_fn=None)


# ========================================================== preemption

def _run(td, d, *, steps=6, sigterm_at=None, micro=1, dropout=0.3,
         seeds=None, **cfg):
    """Train a fresh port model (dropout on) for up to ``steps`` steps;
    ``sigterm_at``: send this process a real SIGTERM while the batch of
    that step is drawn.  ``seeds`` collects each step's dropout seeds."""
    tm = _port(dropout=dropout)
    if seeds is not None:
        inner = tm.train_loss

        def train_loss(p, batch, generator=None):
            seeds.setdefault(len(seeds), generator.initial_seed())
            return inner(p, batch, generator)
        tm.train_loss = train_loss

    def data_fn(s):
        if s == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return td.train_batch(s, 8)

    tr = T_loop.Trainer(tm, T_opt.OptConfig(lr=1e-2),
                        T_loop.TrainConfig(steps=steps, ckpt_dir=d,
                                           ckpt_every=0, log_every=1,
                                           eval_every=0, microbatches=micro,
                                           **cfg),
                        data_fn=data_fn)
    params, hist = tr.run(params=tm.params())
    return tr, _np_tree(params), hist


class TestPreemption:
    @pytest.mark.parametrize("micro", [1, 2])
    def test_sigterm_then_resume_is_bit_equal(self, tmp_path, micro):
        _, td = _data()
        _, want, _ = _run(td, None, micro=micro)
        before = signal.getsignal(signal.SIGTERM)
        d = str(tmp_path)
        tr, _, _ = _run(td, d, sigterm_at=2, micro=micro)
        assert tr._preempted and tr.done_step == 3
        assert T_ckpt.latest_step(d) == 3          # the step reached
        assert signal.getsignal(signal.SIGTERM) is before
        tr, got, hist = _run(td, d, micro=micro)
        assert not tr._preempted and tr.done_step == 6
        assert hist[0]["step"] == 3                # resumed, not restarted
        _assert_bitwise(want, got)
        assert T_ckpt.latest_step(d) == 6

    def test_resumed_runs_draw_the_uninterrupted_masks(self, tmp_path):
        """Two runs resumed at different steps (2 and 4) draw each step's
        dropout from the generator the uninterrupted run drew it from,
        so all three end bit-equal."""
        _, td = _data()
        want_seeds, got_seeds = {}, {}
        _, want, _ = _run(td, None, seeds=want_seeds)
        ends = []
        for stop in (1, 3):
            d = str(tmp_path / f"stop{stop}")
            seeds = {}
            _run(td, d, sigterm_at=stop, seeds=seeds)
            more = {}
            _, got, _ = _run(td, d, seeds=more)
            got_seeds[stop] = {**seeds, **{stop + 1 + k: v
                                           for k, v in more.items()}}
            ends.append(got)
        for stop, seeds in got_seeds.items():
            assert seeds == want_seeds, stop
        for got in ends:
            _assert_bitwise(want, got)
        assert len(set(want_seeds.values())) == 6
        g = T_loop.step_generator(0, 3, "cpu")
        assert g.initial_seed() == want_seeds[3]
        assert T_loop.step_generator(0, 3, "cpu", 0).initial_seed() != \
            g.initial_seed()

    def test_early_stop_state_survives(self, tmp_path):
        _, td = _data()
        metric_by_step = {1: 0.9, 3: 0.8, 5: 0.7, 7: 0.6, 9: 0.5}

        def make(d, preempt_at=None):
            box = {}
            tm = _port()

            def data_fn(s):
                box["step"] = s
                if s == preempt_at:
                    box["tr"]._preempted = True
                return td.train_batch(s, 8)

            tr = T_loop.Trainer(
                tm, T_opt.OptConfig(lr=1e-2),
                T_loop.TrainConfig(steps=20, ckpt_dir=d, ckpt_every=0,
                                   log_every=100, eval_every=2,
                                   early_stop_patience=2),
                data_fn=data_fn,
                eval_fn=lambda p: {"metric": metric_by_step[box["step"]]})
            box["tr"] = tr
            return tr, tm

        ref, tm = make(str(tmp_path / "ref"))
        p_ref, _ = ref.run(params=tm.params())
        assert ref.done_step == 6
        intr, tm = make(str(tmp_path / "int"), preempt_at=2)
        intr.run(params=tm.params())
        assert intr.done_step == 3
        res, tm = make(str(tmp_path / "int"))
        p_res, _ = res.run(params=tm.params())
        assert res.done_step == ref.done_step
        _assert_bitwise(_np_tree(p_ref), _np_tree(p_res))


# ================================================================ CLI

ARGS = ["--device", "cpu", "--n-items", "80", "--d-model", "16",
        "--batch-size", "8", "--eval-every", "0"]


def test_cli_ckpt_dir_round_trip(tmp_path, capsys):
    want = T_cli.main([*ARGS, "--steps", "6"])
    d = str(tmp_path)
    T_cli.main([*ARGS, "--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert T_ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_0000000002", "step_0000000004"]
    got = T_cli.main([*ARGS, "--steps", "6", "--ckpt-dir", d])
    assert "done at step 6 on cpu" in capsys.readouterr().out
    assert [h["step"] for h in got] == [4, 5]
    assert [h["loss"] for h in got] == [h["loss"] for h in want[4:]]


def test_cli_sigterm_prints_preempted(tmp_path, capsys, monkeypatch):
    orig = T_data.SyntheticSequences.train_batch

    def train_batch(self, step, *a, **k):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, step, *a, **k)

    monkeypatch.setattr(T_data.SyntheticSequences, "train_batch",
                        train_batch)
    T_cli.main([*ARGS, "--steps", "5", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "preempted: checkpoint stamped at step 2" in out
    assert T_ckpt.latest_step(str(tmp_path)) == 2


def test_cli_microbatches():
    a = T_cli.main([*ARGS, "--steps", "2", "--microbatches", "2"])
    assert [h["step"] for h in a] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in a)
