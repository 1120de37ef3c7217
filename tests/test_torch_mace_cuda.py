"""MACE's segment sum and training step on the card (no JAX here: the
card's machine has none).  Every test is marked ``cuda`` and skips,
inside the test, where ``torch.cuda.is_available()`` is false; run them
on the H100 with ``PYTHONPATH=src python -m pytest -q --noconftest -m
cuda tests/test_torch_mace_cuda.py``.

Tolerances: ``ops.segment_sum`` (the embedding_bag backward kernels at
L = 1 with unit weights) bit-equal to its plain version on CPU copies,
each row's terms added onto +0.0 in ascending position on both; a MACE
training step (fp32, TF32 off) bit-identical across two runs from the
same weights, since no sum on its path adds with atomics.
"""
import numpy as np
import pytest
import torch

from repro_torch import fp32_matmuls
from repro_torch.configs.mace_arch import SMOKE, smoke_batch
from repro_torch.kernels.embedding_bag import cuda as ec
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.models.mace import MACE
from repro_torch.nn.module import tree_leaves
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import OptConfig

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


@pytest.mark.parametrize("E,n,width", [(5_000, 700, 128 * 5),
                                       (20_000, 40, 3), (300, 512, 16)])
def test_segment_sum_bit_equal_to_plain(dev, E, n, width):
    """A shared order and a per-call sort give the same bits, equal to
    the plain version's on the CPU; long runs (E / n > 64) included."""
    g = torch.Generator(device=dev).manual_seed(E)
    data = torch.randn((E, width), generator=g, device=dev)
    ids = torch.randint(0, n, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    order = eops.segment_order(ids, n)
    before = ec.launches["embedding_bag_backward"]
    got = eops.segment_sum(data, ids, n, order)
    again = eops.segment_sum(data, ids, n)
    assert ec.launches["embedding_bag_backward"] == before + 2
    want = eops.segment_sum(data.cpu(), ids.cpu(), n)
    assert _bits(got.cpu(), want) and _bits(again, got)


def test_two_training_steps_bit_identical(dev):
    batch = smoke_batch()

    def run():
        model = MACE(SMOKE, generator=torch.Generator(device=dev)
                     .manual_seed(0), device=dev)
        tr = Trainer(model, OptConfig(lr=3e-3),
                     TrainConfig(steps=2, log_every=1, eval_every=0),
                     data_fn=lambda s: batch)
        ec.reset_launches()
        params, hist = tr.run(params=model.params())
        return ([h["loss"] for h in hist if "loss" in h],
                [x.detach().cpu() for x in tree_leaves(params)],
                ec.launches["embedding_bag_backward"])

    (l1, p1, n1), (l2, p2, _) = run(), run()
    assert len(l1) == 2 and all(np.isfinite(l1)) and l1 == l2
    assert all(_bits(a, b) for a, b in zip(p1, p2))
    # a step: 14 sums over receivers, the sum over graphs, and the four
    # sender gathers' backward (h[0] in layer 1; h[0..2] in layer 2)
    assert n1 == 2 * (14 + 1 + 4)
