"""The port stands alone: nothing under src/repro_torch, and not
chip_smoke.py, imports ``jax`` or the JAX package ``repro`` (the machine
with the card has no JAX), and importing the port builds no kernel.

A static AST scan, so a stray import fails here rather than on the card.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden_imports(source: str):
    bad = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_files_found():
    files = _port_files()
    assert len(files) >= 15
    for mod in (("kernels", "jpq_topk", "ops.py"),
                ("kernels", "jpq_scores", "ops.py"),
                ("kernels", "jpq_lookup", "ops.py"),
                ("models", "sequential.py"), ("train", "loop.py"),
                ("core", "semantic.py"), ("ckpt", "checkpoint.py"),
                ("launch", "train.py"), ("data", "sequences.py"),
                ("launch", "server.py"), ("serve", "__init__.py"),
                ("serve", "queue.py"), ("serve", "metrics.py"),
                ("serve", "loadgen.py"), ("serve", "registry.py"),
                ("serve", "replica.py"), ("serve", "server.py"),
                ("train", "spec.py"), ("dist", "__init__.py"),
                ("dist", "rules.py"), ("dist", "compression.py"),
                ("launch", "mesh.py"), ("models", "mace.py"),
                ("models", "equivariant.py"), ("data", "graphs.py"),
                ("configs", "mace_arch.py"), ("launch", "dryrun.py"),
                ("dist", "tally.py"), ("kernels", "library.py"),
                ("kernels", "cost.py")):
        assert os.path.join(PORT, *mod) in files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        bad = _forbidden_imports(f.read())
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scanner_catches_every_form():
    for src in ("import jax", "import jax.numpy as jnp",
                "from repro.core import jpq", "from jax import lax",
                "import repro", "importlib.import_module('repro.core')",
                "__import__('jax')"):
        assert _forbidden_imports(src), src
    for src in ("import repro_torch", "from repro_torch.core import jpq",
                "from . import x", "import torch"):
        assert not _forbidden_imports(src), src


def test_import_builds_nothing_and_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.bridge, "
            "repro_torch.configs.recsys_archs, "
            "repro_torch.launch.train, repro_torch.train.loop, "
            "repro_torch.models.sequential, repro_torch.core.semantic, "
            "repro_torch.ckpt, repro_torch.serve, repro_torch.launch.server, "
            "repro_torch.train.spec, repro_torch.dist.compression, "
            "repro_torch.launch.mesh, repro_torch.configs.base, "
            "repro_torch.kernels.jpq_scores.ops, "
            "repro_torch.kernels.jpq_lookup.ops, "
            "repro_torch.kernels.jpq_topk.cuda as c\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), 'jax/repro imported'\n"
            "assert 'triton' not in sys.modules\n"
            "import torch.distributed as d; assert not d.is_initialized()\n"
            "from repro_torch.kernels import build\n"
            "assert not build._LIBS\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
