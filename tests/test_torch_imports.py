"""The port stands alone: every module of ``tclb_tpu_torch`` imports with
JAX and the JAX package unavailable, no module (nor ``chip_smoke.py``)
names them in an import, and its entry points default to the card."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tclb_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tclb_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert "tclb_tpu_torch.ops.d2q9_kernels" in mods
    assert "tclb_tpu_torch.ops.d3q27_kernels" in mods
    assert "tclb_tpu_torch.ops.generic3d_kernels" in mods
    assert "tclb_tpu_torch.models.d3q19_adj" in mods
    assert "tclb_tpu_torch.models.d3q27_bgk" in mods
    assert "tclb_tpu_torch.utils.turbulence" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None      # any import of it now fails
        for mod in {mods!r}:
            importlib.import_module(mod)
        print("imported", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


def test_lattice_defaults_to_the_card():
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    if torch.cuda.is_available():
        assert Lattice(m, (8, 8)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Lattice(m, (8, 8))
    assert Lattice(m, (8, 8), device="cpu").device.type == "cpu"
