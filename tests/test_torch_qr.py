"""Parity of the port's QR compositional embedding (repro_torch.core.qr,
behind ``core/api``'s ``kind="qr"``) with the JAX reference's
``repro.core.qr``, on the CPU, and the bridge carrying the QR tables and
the GRU4Rec tree from the reference's values tree and checkpoint.

Tolerances: ``lookup`` is one product a coordinate, so bit-equal;
``logits`` sums d products in another order than XLA's, so within
atol 1e-5 on tables at init's scale.  ``init``'s scale (``d ** -0.25``) is held within 5% over
10^4 draws a table (the standard error of a sample std is 0.7% there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint
from repro.core import EmbeddingConfig as J_EC
from repro.core import api as J_api
from repro.core import qr as J_qr
from repro.models import sequential as J_seq
from repro.nn import module as J_nn
from repro_torch import bridge
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.core import api as T_api
from repro_torch.core import qr as T_qr
from repro_torch.models import sequential as T_seq
from repro_torch.nn import module as T_nn


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 99, 100, 101, 242, 2002,
                               1_000_002])
def test_qr_base(n):
    assert T_qr.qr_base(n) == J_qr.qr_base(n)


def _tables(n_items, d, seed):
    """Both tables at init's scale, d ** -0.25."""
    q = J_qr.qr_base(n_items)
    rng = np.random.default_rng(seed)
    qt = (rng.standard_normal(((n_items + q - 1) // q, d))
          * d ** -0.25).astype(np.float32)
    rt = (rng.standard_normal((q, d)) * d ** -0.25).astype(np.float32)
    jp = {"q_table": J_nn.P(jnp.asarray(qt), None),
          "r_table": J_nn.P(jnp.asarray(rt), None)}
    return jp, {"q_table": torch.tensor(qt), "r_table": torch.tensor(rt)}


@pytest.mark.parametrize("n_items,d", [(50, 16), (122, 16), (202, 8),
                                       (2002, 64)])
def test_lookup_and_logits(n_items, d):
    jp, tp = _tables(n_items, d, n_items)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, n_items, (3, 7))
    np.testing.assert_array_equal(
        T_qr.lookup(tp, torch.tensor(ids), n_items).numpy(),
        np.asarray(J_qr.lookup(jp, jnp.asarray(ids), n_items)))
    h = rng.standard_normal((2, 5, d)).astype(np.float32)
    got = T_qr.logits(tp, torch.tensor(h), n_items)
    want = np.asarray(J_qr.logits(jp, jnp.asarray(h), n_items))
    assert tuple(got.shape) == (2, 5, n_items) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # every item's score is its looked-up row against h
    rows = T_qr.lookup(tp, torch.arange(n_items), n_items)
    torch.testing.assert_close(got, torch.tensor(h) @ rows.T, rtol=0,
                               atol=1e-4)


def test_embedding_api_routes_qr():
    jc = J_EC(n_items=202, d=8, kind="qr")
    tc = T_EC(n_items=202, d=8, kind="qr")
    jp, tp = _tables(202, 8, 3)
    jemb, temb = J_api.make_embedding(jc), T_api.make_embedding(tc)
    ids = np.arange(0, 202, 5)
    np.testing.assert_array_equal(
        temb.lookup(tp, torch.tensor(ids)).numpy(),
        np.asarray(jemb.lookup(jp, jnp.asarray(ids))))
    h = np.random.default_rng(4).standard_normal((4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        temb.logits(tp, torch.tensor(h)).numpy(),
        np.asarray(jemb.logits(jp, jnp.asarray(h))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("init_scale", [None, 0.3])
def test_init_shapes_and_scale(init_scale):
    n, d = 10_001, 16                    # q = 101, A = 100
    p = T_qr.init(torch.Generator().manual_seed(0), n, d,
                  init_scale=init_scale, device="cpu")
    jp = J_qr.init(J_nn.KeyGen(0), n, d, init_scale=init_scale)
    assert set(p) == set(jp) == {"q_table", "r_table"}
    for k in p:
        assert tuple(p[k].shape) == jp[k].value.shape
        assert p[k].dtype == torch.float32
    assert tuple(p["q_table"].shape) == (100, d)
    assert tuple(p["r_table"].shape) == (101, d)
    scale = init_scale if init_scale is not None else d ** -0.25
    for t in p.values():
        assert abs(float(t.std()) / scale - 1) < 0.05
        assert abs(float(t.mean())) < 0.05 * scale
    # the two tables are distinct draws, q_table first
    g = torch.Generator().manual_seed(0)
    first = torch.randn((100, d), generator=g).mul_(scale)
    assert torch.equal(first, p["q_table"])
    # through the api: the table kind's own default scale
    tab = T_api.make_embedding(T_EC(n_items=n, d=d, kind="qr")).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(tab["q_table"], T_qr.init(
        torch.Generator().manual_seed(0), n, d, device="cpu")["q_table"])


def test_seqrec_qr_keeps_its_own_scale():
    """SeqRecConfig gives full and jpq tables init_scale 0.02 but leaves
    qr's at None (d ** -0.25 a table), as the reference does."""
    for arch in ("sasrec", "gru4rec"):
        t = T_seq.SeqRecConfig(arch=arch, n_items=100,
                               embedding=T_EC(0, 0, kind="qr")).emb_cfg()
        j = J_seq.SeqRecConfig(arch=arch, n_items=100,
                               embedding=J_EC(0, 0, kind="qr")).emb_cfg()
        assert t.init_scale is None and j.init_scale is None
        assert (t.n_items, t.d) == (j.n_items, j.d) == (102, 512)


KW = dict(n_items=120, max_len=8, d_model=16, n_layers=2, n_heads=2,
          d_ff=32)


def _seq_models(arch, kind, seed):
    codes = np.random.default_rng(seed).integers(0, 16, (122, 4)).astype(
        np.int32) if kind == "jpq" else None
    jm = J_seq.SeqRecModel(J_seq.SeqRecConfig(
        arch=arch, embedding=J_EC(0, 0, kind=kind, m=4, b=16), **KW),
        codes=codes)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = T_seq.SeqRecModel(T_seq.SeqRecConfig(
        arch=arch, embedding=T_EC(0, 0, kind=kind, m=4, b=16), **KW),
        codes=codes, generator=torch.Generator().manual_seed(seed + 1),
        device="cpu")
    return jp, tm, jax.tree.map(np.asarray, J_nn.values(jp))


def _assert_same(tree, values, path=""):
    if isinstance(values, dict):
        assert set(tree) == set(values), path
        for k in values:
            _assert_same(tree[k], values[k], f"{path}/{k}")
    elif isinstance(values, list):
        assert len(tree) == len(values), path
        for i, v in enumerate(values):
            _assert_same(tree[i], v, f"{path}/{i}")
    else:
        got = tree.detach().numpy()
        assert got.dtype == values.dtype, path
        np.testing.assert_array_equal(got, values, err_msg=path)


@pytest.mark.parametrize("source", ["values", "npz"])
@pytest.mark.parametrize("arch,kind", [("sasrec", "qr"), ("bert4rec", "qr"),
                                       ("gru4rec", "qr"), ("gru4rec", "jpq"),
                                       ("gru4rec", "full")])
def test_bridge_carries_qr_and_gru_trees(arch, kind, source, tmp_path):
    """``load_values`` and ``load_npz`` carry the reference's
    ``item_emb/{q_table, r_table}`` and ``gru/<i>/{wx, wh, b}``,
    ``proj/{w, b}`` bit-identical; the parameter counts and bytes then
    equal the reference's."""
    jp, tm, values = _seq_models(arch, kind, 2)
    if source == "values":
        bridge.load_values(tm, values)
    else:
        path = save_checkpoint(str(tmp_path), {"values": values}, step=1)
        bridge.load_npz(tm, f"{path}/arrays.npz")
    _assert_same(tm.params(), values)
    assert T_nn.param_count(tm.params()) == J_nn.param_count(jp)
    assert T_nn.param_bytes(tm.params()) == J_nn.param_bytes(jp)


def test_bridge_refuses_a_mismatched_qr_table():
    _, tm, values = _seq_models("sasrec", "qr", 2)
    values["item_emb"]["r_table"] = values["item_emb"]["r_table"][:-1]
    with pytest.raises(ValueError, match="r_table"):
        bridge.load_values(tm, values)
