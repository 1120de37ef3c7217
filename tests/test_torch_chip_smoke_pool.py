"""The rank pools ``chip_smoke.py`` runs its mesh phases on
(``RankPool``: processes started once a world size, handed one rank
function after another), on the CPU over gloo: each task runs on every
rank on a fresh mesh of the shape it asks for, from a new process's
state; a rank that raises is reported with its traceback; ``close``
ends the ranks."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


# rank functions (module-level, so the pool's processes import them by
# name)
def _record(mesh, out_dir, tag):
    total = mesh.all_reduce(torch.full((1,), float(mesh.rank + 1)),
                            ("data", "model"))
    model = mesh.all_reduce(torch.ones(1), "model")
    torch.save({"shape": dict(mesh.shape), "sum": float(total),
                "model_sum": float(model), "calls": mesh.comm["calls"],
                "draw": float(torch.rand(1))},
               os.path.join(out_dir, f"{tag}.{mesh.rank}.pt"))


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    mesh.all_reduce(torch.ones(1), ("data", "model"))


@pytest.fixture(scope="module")
def pools():
    cs.start_pools(CPU, (2, 4))
    yield cs.POOLS
    cs.close_pools()


@pytest.mark.parametrize("n,model", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_a_task_runs_on_every_rank_at_its_shape(pools, tmp_path, n, model):
    for tag in ("first", "again"):
        cs.run_ranks(_record, n, (str(tmp_path), tag), CPU, model=model,
                     timeout=120)
    for r in range(n):
        first, again = (torch.load(tmp_path / f"{tag}.{r}.pt")
                        for tag in ("first", "again"))
        assert first["shape"] == {"data": n // model, "model": model}
        assert first["sum"] == n * (n + 1) / 2
        assert first["model_sum"] == model
        # a fresh mesh a task (its counters from 0), the generators
        # reseeded as a new process starts them
        assert first["calls"] == again["calls"] == 2 - (model == 1)
        assert first["draw"] == again["draw"]


def test_a_failing_rank_is_reported_and_the_pool_ends():
    pool = cs.RankPool(2, CPU)
    try:
        with pytest.raises(RuntimeError, match="(?s)rank 1 of 2.*rank one "
                                               "fails"):
            pool.run(_fail_on_rank_1, timeout=120)
    finally:
        procs = pool.ctx.processes
        pool.close(timeout=0)
    assert not any(p.is_alive() for p in procs)
    assert pool.ctx is None and not os.path.exists(pool.dir)


def test_close_ends_the_ranks_cleanly():
    pool = cs.RankPool(2, CPU)
    procs = pool.ctx.processes
    pool.ready(timeout=120)
    pool.close()
    assert [p.exitcode for p in procs] == [0, 0]
