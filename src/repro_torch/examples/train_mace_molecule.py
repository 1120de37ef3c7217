"""Train MACE on batched synthetic molecules (energy regression), the
reference's ``examples/train_mace_molecule.py``: segment-sum message
passing and exact Gaunt-intertwiner products on the ``molecule`` cell's
reduced config, then the trained model's rotation-invariance check.

    PYTHONPATH=src python -m repro_torch.examples.train_mace_molecule \
        [--steps 200] [--device cpu]

On the card the sums over receivers and graphs run through the
embedding_bag backward kernels, and so do the sender gathers'
gradients; on the CPU their plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

# molecules a batch, atoms a molecule, edges a molecule
GRAPHS, ATOMS, EDGES = 16, 12, 32


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main(argv=None) -> dict:
    from repro_torch import fp32_matmuls, resolve_device
    from repro_torch.data.graphs import molecule_batch
    from repro_torch.models.mace import MACE, MACEConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fp32_matmuls()
    cfg = MACEConfig(n_layers=2, channels=32, lmax=2, correlation=3,
                     n_rbf=8, d_feat=4, head="energy", n_graphs=GRAPHS,
                     r_cut=2.0, avg_neighbors=EDGES / ATOMS)
    model = MACE(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)

    def data_fn(step):
        return molecule_batch(step, batch=GRAPHS, n_nodes=ATOMS,
                              n_edges=EDGES, d_feat=4)

    tr = Trainer(model, OptConfig(lr=2e-3),
                 TrainConfig(steps=args.steps, batch_size=GRAPHS,
                             log_every=max(args.steps // 10, 1),
                             eval_every=0),
                 data_fn=data_fn)
    params, hist = tr.run(params=model.params())
    losses = [h["loss"] for h in hist if "loss" in h]
    print(f"energy MSE: {losses[0]:.4f} -> {losses[-1]:.4f}")

    # rotation-invariance check on the trained model
    batch = data_fn(0)
    Q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((3, 3)))
    rotated = dict(batch)
    rotated["positions"] = batch["positions"] @ Q.T.astype(np.float32)
    with torch.no_grad():
        e1 = model.serve(params, batch)
        e2 = model.serve(params, rotated)
    rel = float(torch.max(torch.abs(e1 - e2) / (torch.abs(e1) + 1e-6)))
    print(f"rotation invariance: max rel err {rel:.2e}")
    return {"losses": losses, "rotation_rel_err": rel}


if __name__ == "__main__":
    main()
