"""The request server's latency and CTR training steps of one or more
trees of this repo, each run in turn on one card: for holding a change
that touches every kernel call (such as the kernels' ``torch.library``
binding) against its parent end to end.

Per tree, in a process of its own with ``PYTHONPATH=TREE/src`` and its
kernels built from its own sources first:
  * the request server at full width (``launch/server.serve_requests``,
    the CLI's body): two-tower-retrieval-jpq, 400 requests, Poisson
    arrivals at 500/s, ``--max-batch 8 --max-delay-ms 5``, in
    ``chip_smoke.py`` phase 25's three configurations (a) the defaults
    (pruned), (b) ``--prune --perm --warm --replicas 2 --merge-every 4``,
    (c) ``--no-prune``: p50 / p95 / p99 ms;
  * CTR training at full width (phase 24's ``Trainer``, adamw lr 3e-3,
    B = 65,536, TF32 off) for fm, fm-jpq and dlrm-rm2-jpq, the bundles
    whose step has the fewest milliseconds a kernel call: 1 + 5 steps on
    ``SyntheticClicks`` batches, the median of the last 5 step times.

Usage, from the root of a checkout on a machine with the card:
  python tools/dispatch_ab.py PARENT CHANGE CHANGE PARENT --out FILE
The trees run in the order given; the card's name and power limit head
the output.  Prints one JSON line a run and writes them all to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SERVER_RUNS = (("a", []),
               ("b", ["--prune", "--perm", "--warm", "--replicas", "2",
                      "--merge-every", "4"]),
               ("c", ["--no-prune"]))
CTR_ARCHS = ("fm", "fm-jpq", "dlrm-rm2-jpq")
CTR_B, CTR_STEPS = 65_536, 5


def one_tree() -> dict:
    """The measurements of the tree on ``sys.path`` (module docstring)."""
    import numpy as np
    import torch

    from repro_torch import fp32_matmuls
    from repro_torch.configs import get_bundle
    from repro_torch.data.clicks import ClickDataConfig, SyntheticClicks
    from repro_torch.kernels import build
    from repro_torch.launch import server as server_mod
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    fp32_matmuls()
    build.build()
    dev = torch.device("cuda", 0)
    out = {"server": {}, "ctr": {}}
    model = get_bundle("two-tower-retrieval-jpq").make_model(device=dev,
                                                             seed=0)
    params = model.params()
    for name, flags in SERVER_RUNS:
        args = server_mod.build_parser().parse_args(
            ["--requests", "400", "--rate", "500", "--max-batch", "8",
             "--max-delay-ms", "5", "--top-k", "10", "--seed", "0",
             "--device", "cuda", *flags])
        snap, wall = server_mod.serve_requests(model, params, args)
        lat = snap["latency_ms"]
        out["server"][name] = {"p50_ms": lat["p50"], "p95_ms": lat["p95"],
                               "p99_ms": lat["p99"], "wall_s": wall,
                               "batches": snap["batches"]}
    del model, params
    torch.cuda.empty_cache()
    for arch in CTR_ARCHS:
        model = get_bundle(arch).make_model(device=dev, seed=0)
        clicks = SyntheticClicks(ClickDataConfig(
            n_dense=getattr(model.cfg, "n_dense", 13),
            vocab_sizes=model.cfg.vocabs(), seed=0))
        keys = ("sparse", "label") if arch.startswith("fm") else \
            ("dense", "sparse", "label")
        bs = [{k: b[k] for k in keys}
              for b in (clicks.batch(s, CTR_B) for s in range(1 + CTR_STEPS))]
        tr = Trainer(model, OptConfig(lr=3e-3), TrainConfig(
            steps=1 + CTR_STEPS, log_every=1, eval_every=0),
            data_fn=lambda s: bs[s])
        _, hist = tr.run(params=model.params())
        secs = [h["sec"] for h in hist if "sec" in h]
        out["ctr"][arch] = {"step_ms": float(np.median(secs[1:])) * 1e3,
                            "steps_ms": [x * 1e3 for x in secs]}
        del model, tr, bs
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree()))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree],
            env=dict(os.environ, PYTHONPATH=os.path.join(tree, "src")),
            cwd=tree, capture_output=True, text=True)
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-4000:])
            return run.returncode
        row = {"run": i, "tree": tree, "card": card,
               "seconds": time.perf_counter() - t0,
               **json.loads(run.stdout.strip().splitlines()[-1])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
