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
(fp32; measured: at most 3.1e-7).  An LM on more than one rank raises,
naming its ROADMAP item, since the reference's own LM fails on a mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt import save_checkpoint as J_save
from repro.configs import get_bundle as J_bundle
from repro.nn import module as J_nn
from repro.train import optimizer as J_opt
from repro_torch.configs.registry import LM_ARCHS
from repro_torch.launch import train as T_cli


def _reference_steps(name, n=2, lr=3e-3):
    """(the reference's smoke values, its n per-step losses)."""
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
    for _ in range(n):
        loss, g = grad(values)
        values, state, _ = J_opt.apply_updates(J_opt.OptConfig(lr=lr),
                                               state, values, g)
        losses.append(float(loss))
    return start, losses


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cli_trains_each_lm_arch_from_reference_weights(name, tmp_path,
                                                        capsys):
    start, want = _reference_steps(name)
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
def test_cli_refuses_an_lm_on_a_mesh(flags):
    with pytest.raises(NotImplementedError, match="item 10c"):
        T_cli.main(["--device", "cpu", "--arch", "olmoe-1b-7b",
                    "--steps", "1", *flags])
