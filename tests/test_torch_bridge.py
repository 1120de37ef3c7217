"""Weights carried from the JAX reference into the port (repro_torch.bridge),
and the modules they feed: embeddings (core/api, core/full, core/jpq) and
the MLP user tower (nn/layers), on the CPU.

Codes and centroids must arrive bit-identical.  The user tower's float32
products sum in another order than XLA's, so it is compared with
rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint
from repro.core import EmbeddingConfig as J_EC
from repro.core import api as J_api
from repro.models.recsys import TwoTower as J_TwoTower
from repro.models.recsys import TwoTowerConfig as J_TTC
from repro.nn import layers as J_L
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import api as T_api
from repro_torch.models.recsys import TwoTower as T_TwoTower
from repro_torch.models.recsys import TwoTowerConfig as T_TTC
from repro_torch.nn import layers as T_L

CFG = dict(n_items=300, embed_dim=32, tower_mlp=(64, 32), hist_len=6)


def _models(kind="jpq", seed=0):
    jm = J_TwoTower(J_TTC(embedding=J_EC(0, 0, kind=kind, m=4, b=16),
                          **CFG))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_TwoTower(T_TTC(embedding=T_EC(0, 0, kind=kind, m=4, b=16),
                          **CFG),
                    generator=torch.Generator().manual_seed(seed + 1),
                    device="cpu")
    return jm, jp, tm, jax.tree.map(np.asarray, J_nn.values(jp))


def _assert_tree_bitwise(tm, values):
    p = tm.params()
    for name in values["item_emb"]:
        want = values["item_emb"][name]
        got = p["item_emb"][name].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    for lj, lt in zip(values["user_mlp"]["layers"], p["user_mlp"]["layers"]):
        for name in ("w", "b"):
            np.testing.assert_array_equal(lt[name].numpy(), lj[name])


class TestBridge:
    @pytest.mark.parametrize("kind", ["jpq", "full"])
    def test_values_tree_bit_identical(self, kind):
        _, _, tm, values = _models(kind)
        bridge.load_values(tm, values)
        _assert_tree_bitwise(tm, values)
        if kind == "jpq":
            assert tm.params()["item_emb"]["codes"].dtype == torch.uint8

    def test_checkpoint_npz(self, tmp_path):
        _, _, tm, values = _models("jpq", seed=3)
        path = save_checkpoint(str(tmp_path), {"values": values}, step=7)
        bridge.load_npz(tm, f"{path}/arrays.npz")
        _assert_tree_bitwise(tm, values)

    def test_unflatten_layout(self):
        flat = {"values/a/layers/0/w": np.zeros(2),
                "values/a/layers/1/w": np.ones(2),
                "values/c": np.arange(3), "opt/x": np.zeros(1)}
        tree = bridge.unflatten(flat)
        assert set(tree) == {"a", "c"}
        assert isinstance(tree["a"]["layers"], list)
        np.testing.assert_array_equal(tree["a"]["layers"][1]["w"], np.ones(2))

    def test_mismatches_raise(self):
        _, _, tm, values = _models("jpq")
        bad = jax.tree.map(lambda x: x, values)
        bad["item_emb"]["codes"] = values["item_emb"]["codes"].astype(
            np.int32)
        with pytest.raises(ValueError, match="codes"):
            bridge.load_values(tm, bad)
        bad = jax.tree.map(lambda x: x, values)
        bad["user_mlp"]["layers"] = bad["user_mlp"]["layers"][:1]
        with pytest.raises(ValueError, match="list"):
            bridge.load_values(tm, bad)
        bad = jax.tree.map(lambda x: x, values)
        bad["item_emb"]["codes"] = np.full_like(values["item_emb"]["codes"],
                                                16)
        with pytest.raises(ValueError, match="< b=16"):
            bridge.load_values(tm, bad)

    def test_codes_are_a_buffer_not_a_parameter(self):
        _, _, tm, _ = _models("jpq")
        assert "item_emb.codes" in dict(tm.named_buffers())
        assert "item_emb.codes" not in dict(tm.named_parameters())
        assert "item_emb.centroids" in dict(tm.named_parameters())


class TestTowerAndEmbeddings:
    @pytest.mark.parametrize("kind", ["jpq", "full"])
    def test_user_vec_on_bridged_params(self, kind):
        jm, jp, tm, values = _models(kind, seed=5)
        bridge.load_values(tm, values)
        hist = np.random.default_rng(5).integers(0, CFG["n_items"] + 1,
                                                 (6, CFG["hist_len"]))
        hist[0] = 0                          # an all-padding history
        ju = np.asarray(jm.user_vec(jp, jnp.asarray(hist)))
        tu = tm.user_vec(tm.params(), torch.tensor(hist)).numpy()
        np.testing.assert_allclose(tu, ju, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm(torch.tensor(hist)).detach().numpy(),
                                   ju, rtol=1e-5, atol=1e-6)

    def test_mlp_and_linear(self):
        rng = np.random.default_rng(6)
        dims = [12, 20, 7]
        tp = T_L.mlp_init(torch.Generator().manual_seed(0), dims,
                          device="cpu")
        for lp in tp["layers"]:
            lp["b"] = torch.tensor(rng.standard_normal(lp["b"].shape),
                                   dtype=torch.float32)
        jp = {"layers": [{k: J_nn.P(jnp.asarray(v.numpy()), None)
                          for k, v in lp.items()} for lp in tp["layers"]]}
        x = rng.standard_normal((5, 12)).astype(np.float32)
        for final_act in (False, True):
            np.testing.assert_allclose(
                T_L.mlp(tp, torch.tensor(x), final_act=final_act).numpy(),
                np.asarray(J_L.mlp(jp, jnp.asarray(x), final_act=final_act)),
                rtol=1e-5, atol=1e-6)
        # lecun-normal init: truncated at 2 std of sqrt(1/fan_in)
        w = tp["layers"][0]["w"]
        assert w.shape == (12, 20)
        assert float(w.abs().max()) <= 2 * (1 / 12) ** 0.5 + 1e-6

    @pytest.mark.parametrize("kind", ["jpq", "full", "qr"])
    def test_compression_report_and_counts(self, kind):
        jc = J_EC(n_items=1000, d=64, kind=kind, m=8, b=256)
        tc = T_EC(n_items=1000, d=64, kind=kind, m=8, b=256)
        assert T_api.compression_report(tc) == J_api.compression_report(jc)
        assert tc.float_param_count() == jc.float_param_count()

    @pytest.mark.parametrize("combiner", ["sum", "mean"])
    def test_bag_lookup(self, combiner):
        _, jp, tm, values = _models("jpq", seed=7)
        bridge.load_values(tm, values)
        rng = np.random.default_rng(7)
        ids = rng.integers(0, 300, 20)
        seg = np.sort(rng.integers(0, 5, 20))
        w = rng.standard_normal(20).astype(np.float32)
        jemb = J_api.make_embedding(J_EC(n_items=512, d=32, kind="jpq", m=4,
                                         b=16))
        temb = T_api.make_embedding(T_EC(n_items=512, d=32, kind="jpq", m=4,
                                         b=16))
        jo = jemb.bag_lookup(jp["item_emb"], jnp.asarray(ids),
                             jnp.asarray(seg), 6, combiner=combiner,
                             weights=jnp.asarray(w))
        to = temb.bag_lookup(tm.params()["item_emb"], torch.tensor(ids),
                             torch.tensor(seg), 6, combiner=combiner,
                             weights=torch.tensor(w))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            T_api.make_embedding(temb.cfg).lookup(tm.params()["item_emb"],
                                                  torch.tensor(ids)).numpy(),
            np.asarray(jemb.lookup(jp["item_emb"], jnp.asarray(ids))))
