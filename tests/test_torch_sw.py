"""``sw`` on the CPU: the plain band and resident engines of its generic
kernels against the JAX package's generic engines in interpret mode and
its XLA engine (``test_torch_onestage.check_plain_engines``), and
example/sw_wave.xml's mass in f64 and f32 on both packages.  What the
one-stage models share is in ``tests/test_torch_onestage.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import pathlib  # noqa: E402
import xml.etree.ElementTree as ET  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.models import get_model  # noqa: E402
from test_torch_onestage import check_plain_engines  # noqa: E402

SW_WAVE = pathlib.Path(__file__).resolve().parents[1] / "example" \
    / "sw_wave.xml"


def test_plain_engines_match_pallas():
    check_plain_engines("sw")


def test_sw_wave_mass_drift_is_f32_rounding(tmp_path):
    """sw_wave.xml's total height (an f64 sum) over 300 steps: conserved
    to 1e-12 in f64; in f32 it grows by about 5e-9 a step on the port's
    eager engine and on the JAX package's XLA engine alike (the inverse
    moment basis' float coefficients), which is why chip_smoke.py holds
    the kernels' mass against eager f32's and conservation at f64."""
    drift = {}
    for tag, run_root, get, dtype, kw in (
            ("f64", solver._run_root, get_model, torch.float64,
             {"device": "cpu"}),
            ("f32", solver._run_root, get_model, torch.float32,
             {"device": "cpu"}),
            ("ref f32", jax_solver._run_root, jax_model, jnp.float32, {})):
        root = ET.parse(SW_WAVE).getroot()
        for el in root.findall("Log") + root.findall("Solve"):
            root.remove(el)
        out = tmp_path / tag.replace(" ", "_")
        root.set("output", str(out) + "/")
        lat = run_root(root, get("sw"), None, dtype, str(out) + "/", "case",
                       **kw).lattice
        mass0 = float(np.asarray(lat.get_quantity("Rho"), np.float64).sum())
        lat.iterate(300)
        mass = float(np.asarray(lat.get_quantity("Rho"), np.float64).sum())
        drift[tag] = (mass - mass0) / mass0
    assert abs(drift["f64"]) < 1e-12, drift
    assert 1e-7 < drift["f32"] < 1e-5 and 1e-7 < drift["ref f32"] < 1e-5, \
        drift
    assert abs(drift["f32"] - drift["ref f32"]) < 0.2 * drift["ref f32"], \
        drift
