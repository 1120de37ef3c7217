"""Training the LM archs through the port's entry point
(``repro_torch.launch.train --arch A``) on the CPU against the JAX
reference.

Each LM bundle's smoke model starts from the reference's smoke weights:
they are written as a reference checkpoint at step 0 (the values and a
fresh optimizer state), and the CLI resumes from it with ``--ckpt-dir``,
then trains its two steps (adamw, lr 3e-3, the CLI's defaults) on the
bundle's fixed batch.  The reference takes the same two steps
(``jax.value_and_grad`` + ``train/optimizer.apply_updates``, as its
``Trainer`` steps).  Tolerance: each step's loss within 1e-5 relative
(fp32; measured: at most 3.1e-7).  On a mesh (``--devices 2``,
``--model-axis 2``: two gloo ranks) the CLI resumes from the same
checkpoint and its losses are held to the reference's steps the same
way, at two dispatch groups on two data ranks (the reference's own LM
fails on a mesh, so its single-device step is the anchor; the MoE's
groups are patched as tests/test_torch_lm_mesh.py patches them).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import dist as J_dist
from repro.ckpt import save_checkpoint as J_save
from repro.configs import get_bundle as J_bundle
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch.configs.registry import LM_ARCHS
from repro_torch.launch import train as T_cli


def reference_steps(name, n=2, lr=3e-3, groups=1):
    """(the reference's smoke values, its n per-step losses).  ``groups``
    > 1: the MoE dispatches that many groups (the reference's
    ``dist.data_shard_count`` patched for the call), as the reference's
    run on ``groups`` data ranks would."""
    jm, batch, rng = J_bundle(name).make_smoke()
    jp = jm.init_params(rng)
    values = J_nn.values(jp)
    start = values
    state = J_opt.init_opt_state(values)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def grad(v):
        return jax.value_and_grad(lambda vv: jm.train_loss(
            J_nn.with_values(jp, vv), jb)[0])(v)

    losses = []
    with pytest.MonkeyPatch.context() as mp:
        if groups > 1:
            mp.setattr(J_dist, "data_shard_count", lambda: groups)
        for _ in range(n):
            loss, g = grad(values)
            values, state, _ = J_opt.apply_updates(J_opt.OptConfig(lr=lr),
                                                   state, values, g)
            losses.append(float(loss))
    return start, losses


def cli_losses(name, flags, capfd, steps=2):
    """The losses ``launch/train.py --device cpu --arch A --steps N
    [flags]`` prints (rank 0's history rows where it spawns ranks),
    after checking its closing line."""
    capfd.readouterr()
    hist = T_cli.main(["--device", "cpu", "--arch", name, "--steps",
                       str(steps), *flags])
    out = capfd.readouterr().out
    if hist is not None:
        assert f"done at step {steps} on cpu" in out
        return [h["loss"] for h in hist if "loss" in h]
    D, S = T_cli.mesh_dims(T_cli.build_parser().parse_args(
        ["--arch", name, *flags]))
    assert (f"done at step {steps} on cpu, mesh {{'data': {D}, "
            f"'model': {S}}}") in out
    rows = [ln for ln in out.splitlines() if ln.startswith("{'step'")]
    return [float(re.search(r"'loss': ([^,}]+)", ln).group(1))
            for ln in rows if "'loss'" in ln]


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cli_trains_each_lm_arch_from_reference_weights(name, tmp_path,
                                                        capsys):
    start, want = reference_steps(name)
    d = str(tmp_path / "ck")
    J_save(d, {"values": start, "opt": J_opt.init_opt_state(start)}, 0)
    hist = T_cli.main(["--device", "cpu", "--arch", name, "--steps", "2",
                       "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert f"arch {name}: training the reduced smoke config" in out
    assert "done at step 2 on cpu" in out
    rows = [h for h in hist if "loss" in h]
    assert [h["step"] for h in rows] == [0, 1]
    assert {"ce", "aux"} <= set(rows[0])
    np.testing.assert_allclose([h["loss"] for h in rows], want, rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--model-axis", "2"]])
def test_cli_refuses_an_lm_on_a_mesh(flags, tmp_path, capfd):
    """An LM trains on a mesh (item 10c): olmoe-1b-7b's two CLI steps on
    two gloo ranks, resumed from the reference's smoke weights, within
    1e-5 relative of the reference's two steps; on two data ranks each
    rank's tokens are one dispatch group, so the reference's steps are
    taken at two groups, as its mesh run would dispatch them."""
    D, _ = T_cli.mesh_dims(T_cli.build_parser().parse_args(flags))
    start, want = reference_steps("olmoe-1b-7b", groups=D)
    d = str(tmp_path / "ck")
    J_save(d, {"values": start, "opt": J_opt.init_opt_state(start)}, 0)
    got = cli_losses("olmoe-1b-7b", [*flags, "--ckpt-dir", d], capfd)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
