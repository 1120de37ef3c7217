"""The ranks of a mesh agree on the checkpoint they resume from
(``repro_torch.train.loop.Trainer``): rank 0 alone reads the directory
and broadcasts the step every rank restores, and ``run`` returns on no
rank before that run's last checkpoint is committed.

Two gloo ranks on the CPU train a small SASRec at (1, 2), every leaf
the model splits cut to the rank's blocks.  Inside the spawned ranks
only, ``repro_torch.ckpt.checkpoint.save_checkpoint`` is wrapped so
that rank 0's writes sleep ``DELAY`` seconds before they write: a rank
that read the directory on its own while rank 0's write was in flight
would find no step, start at 0 while rank 0 starts at 2, and pair its
collectives with the wrong ones (gloo aborts on their sizes, or the
ranks train on from different steps).  Each rank saves at step 2 and
resumes at once with no barrier of its own, then resumes again from the
directory holding steps 2 and 4.

Held, on every rank:
  * the directory holds the run's last step as soon as ``run`` returns;
  * the first resumed step is 2, and the second resume's is 4;
  * the resumed losses and every gathered parameter are bit-equal to
    the uninterrupted runs' (to step 4 and to step 6).
"""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch import dist as T_dist
from repro_torch.ckpt import checkpoint as T_ckpt
from repro_torch.core import EmbeddingConfig as T_EC
from repro_torch.launch import mesh as M
from repro_torch.models import sequential as T_seq
from repro_torch.train import loop as T_loop
from repro_torch.train import optimizer as T_opt

SPAWN_TIMEOUT = 90      # a hang after a collective mismatch fails here
DELAY = 0.5             # seconds rank 0's write sleeps before it writes
N_ITEMS, B, STEPS = 130, 4, 6
KW = dict(arch="sasrec", loss="full_ce", n_items=N_ITEMS, max_len=10,
          d_model=16, n_layers=2, n_heads=4, d_ff=32, n_negatives=2)


# ----------------------------------------------------------- the worker
# (module-level, so spawned processes import it by name)

def _model():
    codes = np.random.default_rng(1).integers(
        0, 16, (N_ITEMS + 2, 4)).astype(np.int32)
    emb = T_EC(0, 0, kind="jpq", m=4, b=16, use_kernel=True)
    return T_seq.SeqRecModel(T_seq.SeqRecConfig(embedding=emb, **KW),
                             codes=codes,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")


def _batches():
    """STEPS batches of B left-padded rows of 10, with labels and two
    negatives a position."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        seq = rng.integers(1, N_ITEMS + 1, (B, 10))
        for r in range(B):
            seq[r, :r + 1] = 0
        labels = np.roll(seq, -1, 1)
        labels[:, -1] = rng.integers(1, N_ITEMS + 1, B)
        labels[seq == 0] = 0
        neg = rng.integers(1, N_ITEMS, seq.shape + (2,))
        out.append({"seq": seq, "labels": labels,
                    "negatives": neg + (neg >= labels[..., None])})
    return out


def _slow_rank0_writes(rank):
    """Rank 0's checkpoint writes sleep ``DELAY`` s before they write
    (the async writer calls the module's ``save_checkpoint``)."""
    real = T_ckpt.save_checkpoint

    def slow(*args, **kwargs):
        if rank == 0:
            time.sleep(DELAY)
        return real(*args, **kwargs)
    T_ckpt.save_checkpoint = slow


def _run(mesh, batches, steps, ckpt_dir=None):
    """(first step run, losses, this rank's blocks, their placement) of
    one Trainer run.  It issues no collective after ``run`` returns: one
    would hold back the rank that returned first."""
    tm = _model()
    tr = T_loop.Trainer(tm, T_opt.OptConfig(lr=3e-3), T_loop.TrainConfig(
        steps=steps, batch_size=B, log_every=1, eval_every=0,
        ckpt_dir=ckpt_dir, ckpt_every=2), data_fn=lambda s: batches[s],
        mesh=mesh)
    params, hist = tr.run(params=tm.params())
    rows = [h for h in hist if "loss" in h]
    return [rows[0]["step"], [h["loss"] for h in rows], params, tr._specs]


def _gather_whole(mesh, run):
    """``run``'s blocks made {name: whole leaf} (every rank calls it)."""
    specs = dict(_items(run[3]))
    run[2] = {k: T_dist.gather_block(x.detach(), specs[k], mesh).numpy()
              for k, x in _items(run[2])}
    del run[3]


def _items(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}/{i}")
    else:
        yield path, tree


def _worker(mesh, ckpt_dir, out_dir):
    torch.set_num_threads(1)
    _slow_rank0_writes(mesh.rank)
    batches = _batches()
    out = {"to4": _run(mesh, batches, 4), "to6": _run(mesh, batches, 6)}
    _run(mesh, batches, 2, ckpt_dir)                  # saved at step 2
    out["after_save"] = T_ckpt.latest_step(ckpt_dir)
    out["resumed"] = _run(mesh, batches, 4, ckpt_dir)
    out["after_resume"] = sorted(T_ckpt._all_steps(ckpt_dir))
    out["again"] = _run(mesh, batches, 6, ckpt_dir)
    for key in ("to4", "to6", "resumed", "again"):
        _gather_whole(mesh, out[key])
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


# --------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_agreement")
    M.spawn(_worker, 2, (str(root / "ck"), str(root)), model=2,
            timeout=SPAWN_TIMEOUT)
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("rank", [0, 1])
def test_run_returns_with_its_last_checkpoint_committed(ranks, rank):
    r = ranks[rank]
    assert r["after_save"] == 2
    assert r["after_resume"] == [2, 4]


@pytest.mark.parametrize("rank", [0, 1])
def test_every_rank_resumes_at_rank0s_step(ranks, rank):
    assert ranks[rank]["resumed"][0] == 2
    assert ranks[rank]["again"][0] == 4


@pytest.mark.parametrize("rank", [0, 1])
def test_resume_is_bit_equal_to_the_uninterrupted_run(ranks, rank):
    r = ranks[rank]
    _, losses4, whole4 = r["to4"]
    _, losses6, whole6 = r["to6"]
    assert losses6[:4] == losses4
    assert r["resumed"][1] == losses4[2:]
    _bit_equal(r["resumed"][2], whole4)
    assert r["again"][1] == losses6[4:]
    _bit_equal(r["again"][2], whole6)


def test_ranks_agree_with_each_other(ranks):
    for key in ("resumed", "again"):
        assert ranks[0][key][1] == ranks[1][key][1]
        _bit_equal(ranks[0][key][2], ranks[1][key][2])
