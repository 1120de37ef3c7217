"""The LM family's paths on the card against their plain versions on the
CPU (no JAX here: the card's machine has none).  Every test is marked
``cuda`` and skips, inside the test, where ``torch.cuda.is_available()``
is false; run them on the H100 with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_lm_cuda.py``.

Tolerances: ``ops.jpq_scores`` bit-equal to ``ref.jpq_scores_ref`` on
the card (one LUT einsum, then kernel and plain version agree bit for
bit); a bf16 table gather's gradient (the bag backward, fp32 sums
rounded once to bf16) bit-equal to the same route's plain version on
CPU copies; the MoE and the smoke LMs in fp32 with TF32 off within 1e-5
of the largest magnitude of the CPU's result (cuBLAS sums in another
order), the MoE's routing equal, and a MoE training step bit-identical
across two runs on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge, fp32_matmuls
from repro_torch.configs import get_bundle
from repro_torch.configs.registry import LM_ARCHS
from repro_torch.kernels.embedding_bag import cuda as ec
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.kernels.jpq_scores import cuda as sc
from repro_torch.kernels.jpq_scores import ops as sops
from repro_torch.kernels.jpq_scores import ref as sref
from repro_torch.nn import moe as T_moe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    fp32_matmuls()
    return torch.device("cuda")


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _close(got, want, tol=1e-5):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_ops_jpq_scores_is_the_ref_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((3, 40, 256), generator=g, device=dev)
    cent = torch.randn((8, 256, 32), generator=g, device=dev)
    codes = torch.randint(0, 256, (5_000, 8), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    before = sc.launches["jpq_scores"]
    got = sops.jpq_scores(h, cent, codes)
    assert sc.launches["jpq_scores"] == before + 1
    assert got.shape == (3, 40, 5_000)
    assert _bits(got, sref.jpq_scores_ref(h, cent, codes))


def test_bf16_table_gather_gradient_is_the_plain_route(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((97, 64), generator=g, device=dev).bfloat16()
    ids = torch.randint(0, 97, (300,), generator=g, device=dev)
    ids[:150] = 96                                  # one long run
    dout = torch.randn((300, 64), generator=g, device=dev).bfloat16()
    t = table.clone().requires_grad_(True)
    before = ec.launches["embedding_bag_backward"]
    (got,) = torch.autograd.grad(eops.gather(t, ids), t, dout)
    assert ec.launches["embedding_bag_backward"] == before + 1
    assert got.dtype == torch.bfloat16
    tc = table.cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(eops.gather(tc, ids.cpu()), tc,
                                  dout.cpu())
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def _moe_pair(dev):
    cfg = T_moe.MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=96,
                          capacity_factor=1.0)
    p = T_moe.moe_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    x = torch.randn((256, 64), generator=torch.Generator().manual_seed(3))
    return cfg, p, x


def test_moe_on_the_card_matches_the_cpu(dev):
    cfg, p, x = _moe_pair(dev)
    want, waux = T_moe.moe_apply(p, cfg, x)
    got, gaux = T_moe.moe_apply({k: v.to(dev) for k, v in p.items()}, cfg,
                                x.to(dev))
    _close(got, want)
    _close(gaux, waux)
    probs = torch.softmax(x @ p["router"], -1)
    _, idx = T_moe.top_k(probs, cfg.top_k)
    C = T_moe.capacity(cfg, x.shape[0])
    a = T_moe.route(idx, cfg.n_experts, C)
    b = T_moe.route(idx.to(dev), cfg.n_experts, C)
    assert torch.equal(a[1], b[1].cpu()) and torch.equal(a[0], b[0].cpu())


def test_moe_gradient_is_bit_identical_run_to_run(dev):
    cfg, p, x = _moe_pair(dev)
    outs = []
    for _ in range(2):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xd = x.to(dev).bfloat16().requires_grad_(True)
        y, aux = T_moe.moe_apply(leaves, cfg, xd)
        (y.float().square().sum() + aux).backward()
        outs.append([leaves[k].grad for k in sorted(leaves)] + [xd.grad])
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b.view(torch.int32))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_lm_on_the_card_matches_the_cpu(arch, dev):
    """The smoke model (fp32) on the card and on the CPU from the same
    weights: the loss, the logits and a decode step's logits."""
    cpu, batch = get_bundle(arch).make_smoke(device="cpu", seed=0)
    card, _ = get_bundle(arch).make_smoke(device=dev, seed=0)
    bridge.load_values(card, _np_tree(cpu.params()))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        lc_, _ = cpu.train_loss(cpu.params(), tb)
        lg_, _ = card.train_loss(card.params(),
                                 {k: v.to(dev) for k, v in tb.items()})
        _close(lg_, lc_)
        toks = tb["tokens"]
        cc = cpu.init_caches(2, 16, torch.float32)
        cg = card.init_caches(2, 16, torch.float32)
        for t in range(4):
            a, _ = cpu.decode_step(cpu.params(), toks[:, t:t + 1], cc)
            b, _ = card.decode_step(card.params(), toks[:, t:t + 1].to(dev),
                                    cg)
            _close(b, a)
        assert cg["pos"].tolist() == [4] * card.cfg.n_layers


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def test_lm_training_step_launches_the_bag_backward(dev):
    """One training step of the olmoe smoke model on the card: the token
    gather and every MoE gather take their gradients from the bag
    backward (1 + layers x (1 + top_k) launches)."""
    model, batch = get_bundle("olmoe-1b-7b").make_smoke(device=dev, seed=0)
    params = model.params()
    ec.reset_launches()
    loss, _ = model.train_loss(params, {k: torch.as_tensor(v, device=dev)
                                        for k, v in batch.items()})
    loss.backward()
    cfg = model.cfg
    assert ec.launches["embedding_bag_backward"] == \
        1 + cfg.n_layers * (1 + cfg.moe.top_k)
    assert np.isfinite(float(loss))
