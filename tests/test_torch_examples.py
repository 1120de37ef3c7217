"""The port's examples (repro_torch.examples) on the CPU, and the grid's
parameter sizes against the JAX reference; the train CLI on the new
archs and tables.

The examples run with their kernels' plain versions here; each must print
or write finite numbers.  ``param_bytes`` / ``param_count`` of all 30
(profile, arch, variant) grid models equal the reference's exactly: the
grid data and codebooks are the same numpy arrays on both sides, and the
counts do not depend on the weights.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import EmbeddingConfig as J_EC
from repro.core import assign as J_assign
from repro.data import sequences as J_data
from repro.models import sequential as J_seq
from repro.nn import module as J_nn
from repro_torch.examples import paper_validation as pv
from repro_torch.examples import quickstart, serve_retrieval
from repro_torch.launch import train as T_cli
from repro_torch.nn import module as T_nn


def test_quickstart_on_cpu(capsys):
    res = quickstart.main(["--steps", "2", "--device", "cpu"])
    assert set(res) == {"base", "recjpq-svd"}
    for r in res.values():
        for key in ("ndcg10", "hr10", "final_loss"):
            assert math.isfinite(r[key]), (key, r)
        assert 0.0 <= r["ndcg10"] <= r["hr10"] <= 1.0
    assert res["recjpq-svd"]["param_bytes"] < res["base"]["param_bytes"]
    assert "NDCG@10 base=" in capsys.readouterr().out


def test_serve_retrieval_on_cpu(capsys):
    res = serve_retrieval.main(["--n-items", "20000", "--device", "cpu"])
    assert res["fused_ids_equal"] and res["pruned_ids_equal"]
    assert res["fused_max_abs_dv"] == 0.0
    assert res["jpq_scores_max_abs_diff"] == 0.0
    assert sorted(res["ms_per_batch"]) == [1, 32, 256]
    assert all(math.isfinite(v) for v in res["ms_per_batch"].values())
    out = capsys.readouterr().out
    assert "pruned ids equal=True" in out and "batch= 256" in out
    nf = serve_retrieval.main(["--n-items", "3000", "--no-fused",
                               "--device", "cpu"])
    assert nf["fused_ids_equal"] and nf["pruned_ids_equal"]


def test_paper_validation_on_cpu(tmp_path):
    out = tmp_path / "grid.json"
    rows = pv.main(["--steps", "2", "--archs", "sasrec,bert4rec,gru4rec",
                    "--datasets", "gowalla", "--smoke", "--device", "cpu",
                    "--out", str(out)])
    assert json.loads(out.read_text()) == rows
    assert [(r["arch"], r["variant"]) for r in rows] == [
        (a, v) for a in ("sasrec", "bert4rec", "gru4rec")
        for v in pv.VARIANTS]
    for r in rows:
        assert set(r) == {"dataset", "long_tail", "arch", "variant",
                          "ndcg10", "param_bytes", "rel_size_pct",
                          "train_s"}
        assert math.isfinite(r["ndcg10"]) and 0.0 <= r["ndcg10"] <= 1.0
        assert r["param_bytes"] > 0 and r["dataset"] == "gowalla"
    base = {r["arch"]: r["param_bytes"] for r in rows
            if r["variant"] == "base"}
    for r in rows:
        assert r["rel_size_pct"] == round(
            100 * r["param_bytes"] / base[r["arch"]], 1)


def test_make_data_profiles():
    for profile, n_items, seq_len in (("ml1m", 240, 32),
                                      ("gowalla", 2000, 24)):
        d = pv.make_data(profile)
        assert (d.cfg.n_items, d.cfg.seq_len) == (n_items, seq_len)
        s = pv.make_data(profile, smoke=True).cfg
        assert (s.n_users, s.n_items, s.seq_len) == (120, 80, 12)
    assert pv.make_data("ml1m").long_tail_share() == 0.0
    assert pv.make_data("gowalla").long_tail_share() > 0.75


@pytest.fixture(scope="module")
def grid_codes():
    """Each profile's data and codebooks, built once by the reference:
    {profile: (data, {strategy: codes})}."""
    out = {}
    for profile in ("ml1m", "gowalla"):
        cfg = pv.make_data(profile).cfg
        jd = J_data.SyntheticSequences(
            J_data.SeqDataConfig(**dataclasses.asdict(cfg)))
        u, i = jd.train_interactions()
        out[profile] = (jd, {
            s: J_assign.build_codebook(
                s, cfg.n_items + 2, 8, 64, interactions=(u, i + 1),
                n_users=jd.n_users_eff, seed=0,
                **({"epochs": 3} if s == "bpr" else {}))
            for s in ("random", "svd", "bpr")})
    return out


@pytest.mark.parametrize("profile", ["ml1m", "gowalla"])
@pytest.mark.parametrize("arch", ["sasrec", "bert4rec", "gru4rec"])
def test_grid_param_sizes_match_reference(grid_codes, profile, arch):
    """For each of the 5 variants: the port's grid model (variant_model)
    has the reference's parameter count and bytes, and its codebook is
    the reference's, array-equal."""
    jd, codes = grid_codes[profile]
    data = pv.make_data(profile)
    for variant in pv.VARIANTS:
        tm = pv.variant_model(arch, data, variant, device="cpu")
        strat = variant.split("-")[1] if variant.startswith("jpq") else None
        emb = {"base": None, "qr": J_EC(0, 0, kind="qr")}.get(
            variant, J_EC(0, 0, kind="jpq", m=8, b=64))
        jm = J_seq.SeqRecModel(J_seq.SeqRecConfig(
            arch=arch, n_items=jd.cfg.n_items, max_len=jd.cfg.seq_len,
            d_model=64, n_layers=2, n_heads=2, d_ff=128, embedding=emb),
            codes=codes.get(strat))
        jp = jm.init_params(jax.random.PRNGKey(0))
        tp = tm.params()
        assert T_nn.param_count(tp) == J_nn.param_count(jp), variant
        assert T_nn.param_bytes(tp) == J_nn.param_bytes(jp), variant
        if strat is not None:
            np.testing.assert_array_equal(
                tp["item_emb"]["codes"].numpy(),
                np.asarray(jp["item_emb"]["codes"].value))


@pytest.mark.parametrize("n_negatives", [1, 3])
def test_train_seqrec_draws_negatives_for_sampled_bce(n_negatives,
                                                      monkeypatch):
    """A sampled_bce model's batches carry ``n_negatives`` negatives a
    position, drawn by ``train_batch`` as the reference's harness draws
    them (benchmarks/common.py), and the run scores the test split."""
    data = pv.make_data("ml1m", smoke=True)
    model = pv.variant_model("sasrec", data, "jpq-svd", device="cpu")
    model.cfg = dataclasses.replace(model.cfg, loss="sampled_bce",
                                    n_negatives=n_negatives)
    seen = []
    inner = model.train_loss

    def train_loss(p, batch, generator=None):
        seen.append(tuple(batch["negatives"].shape))
        want = data.train_batch(len(seen) - 1, pv.BATCH,
                                n_negatives=n_negatives)["negatives"]
        np.testing.assert_array_equal(batch["negatives"].numpy(), want)
        return inner(p, batch, generator)

    monkeypatch.setattr(model, "train_loss", train_loss)
    _, ndcg, _ = pv.train_seqrec(model, data, steps=2)
    assert seen == [(pv.BATCH, data.cfg.seq_len, n_negatives)] * 2
    assert math.isfinite(ndcg)


@pytest.mark.parametrize("flags", [["--arch", "bert4rec"],
                                   ["--arch", "gru4rec"],
                                   ["--embedding", "qr"],
                                   ["--arch", "gru4rec", "--embedding", "qr"]])
def test_train_cli_new_paths_on_cpu(flags, capsys):
    hist = T_cli.main(["--device", "cpu", "--steps", "3", "--n-items", "200",
                       "--d-model", "16", "--eval-every", "2",
                       "--batch-size", "8", *flags])
    losses = [h["loss"] for h in hist if "loss" in h]
    evals = [h["eval_ndcg10"] for h in hist if "eval_ndcg10" in h]
    assert losses and all(math.isfinite(v) for v in losses)
    assert evals and all(math.isfinite(v) for v in evals)
    assert "done at step 3 on cpu" in capsys.readouterr().out


def test_train_cli_bert4rec_masks_by_step():
    """The bert4rec data function masks each step's batch with a generator
    seeded from the step: the same step gives the same batch."""
    args = T_cli.build_parser().parse_args(
        ["--device", "cpu", "--arch", "bert4rec", "--n-items", "200",
         "--d-model", "16", "--batch-size", "8", "--embedding", "full"])
    model, data_fn, _, _, _ = T_cli.build(args)
    a, b, c = data_fn(4), data_fn(4), data_fn(5)
    assert set(a) == {"seq", "targets"}
    assert torch.equal(a["seq"], b["seq"]) and torch.equal(a["targets"],
                                                           b["targets"])
    assert not torch.equal(a["seq"], c["seq"])
    assert bool((a["seq"] == model.cfg.mask_id).any())


@pytest.mark.parametrize("entry", [
    lambda: T_cli.main(["--steps", "1", "--n-items", "50", "--arch",
                        "bert4rec"]),
    lambda: quickstart.main(["--steps", "1"]),
    lambda: serve_retrieval.main(["--n-items", "100"]),
    lambda: pv.main(["--steps", "1", "--smoke"]),
], ids=["train-bert4rec", "quickstart", "serve_retrieval",
        "paper_validation"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
