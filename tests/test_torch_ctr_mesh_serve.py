"""``launch/serve.py --mesh S`` for FM, DLRM-RM2 and DIEN (full and
``-jpq``) on gloo CPU processes, against the unsharded path of the
port.

Serving splits only the catalogue's rows (``bridge.keep_local_rows``):
FM's and DLRM's tables (and FM's ``linear``) and the ``-jpq`` codes,
where S divides their rows; DIEN's ``n_items + 1`` rows (101 at the
smoke config) divide by neither 2 nor 4 and stay whole, as the
reference's divisibility fallback keeps them.  The fields' rows are
gathered across the ranks by ``core/sharded.take_rows``, which adds one
nonzero term to zeros, so every rank's every response is held bit-equal
to the unsharded loop's on the same seeded requests (the sign of a zero
before the sigmoid is the only freedom, and the sigmoid of either is
0.5).
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as T_serve

ARCHS = ["fm", "fm-jpq", "dlrm-rm2", "dlrm-rm2-jpq", "dien", "dien-jpq"]
SPAWN_TIMEOUT = 150
ARGV = ["--device", "cpu", "--requests", "3", "--batch-size", "16"]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_mesh_bit_equal_to_unsharded(arch, S):
    args = T_serve.build_parser().parse_args(
        ARGV + ["--arch", arch, "--mesh", str(S)])
    ranks = T_serve.serve_mesh(args, keep_outputs=True,
                               timeout=SPAWN_TIMEOUT)
    model, template = T_serve.smoke_model(arch, torch.device("cpu"))
    plain = T_serve.serve_loop(
        model, model.params(), template,
        T_serve.build_parser().parse_args(ARGV + ["--arch", arch]),
        keep_outputs=True)
    assert len(ranks) == S
    for res in ranks:
        assert res["mesh"] == S and res["path"] == "serve"
        assert len(res["outputs"]) == len(plain["outputs"]) == 3
        for got, want in zip(res["outputs"], plain["outputs"]):
            assert got.shape == want.shape == (16,)
            assert np.array_equal(got.numpy(), want.numpy())
    # the tables S divides are served from this rank's rows: the fields'
    # gathers are collectives; DIEN's 101 rows stay whole, no collective
    calls = ranks[0]["comm_calls"]
    assert (min(calls) == 0) == arch.startswith("dien")


@pytest.mark.parametrize("arch", ["fm", "dlrm-rm2-jpq", "dien"])
def test_keep_local_rows_cuts_the_catalogue_leaves(arch):
    """Each catalogue leaf S divides holds this rank's rows after
    ``keep_local_rows``, the rest whole: FM's table and ``linear``, the
    DLRM codes; DIEN's 101-row table stays whole."""
    model, _ = T_serve.smoke_model(arch, torch.device("cpu"))
    before = {k: v.clone() for k, v in _flat(model.params()).items()}
    mesh = M.HostMesh(1, 2, rank=1)
    bridge.keep_local_rows(model, mesh)
    after = _flat(model.params())
    cut = sorted(k for k in after if after[k].shape != before[k].shape)
    want = {"fm": ["emb/table", "linear"], "dlrm-rm2-jpq": ["emb/codes"],
            "dien": []}[arch]
    assert cut == want
    for k in cut:
        n = before[k].shape[0] // 2
        assert torch.equal(after[k], before[k][n:])


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}
