"""``d2q9_solid`` on the CPU: the plain band and resident engines of its
generic kernels against the JAX package's generic engines in interpret
mode and its XLA engine (``test_torch_onestage.check_plain_engines``), the
fi_s Field stencil across the periodic edges and walls, and mirrors of
tests/test_physics_constitutive.py's seed growth and curvature getter.
What the one-stage models share is in ``tests/test_torch_onestage.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_iterate as jax_make_iterate  # noqa: E402,E501
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from test_torch_onestage import (F64_TOL, _assert_state,  # noqa: E402
                                 _copy, check_plain_engines)
from torch_cases import RICH_ONESTAGE_SETTINGS  # noqa: E402


def test_plain_engines_match_pallas():
    check_plain_engines("d2q9_solid")


def test_solid_field_stencil_across_edges():
    """d2q9_solid's fi_s stencil at the lattice's periodic edges and next
    to walls: fully solid nodes on the first row and column (so every
    neighbourhood that crosses an edge sees them), growth there; two eager
    steps against the JAX package's XLA engine at f64.  (The rich state of
    the f32 engine tests has solid first rows and columns too.)"""
    name = "d2q9_solid"
    shape = (8, 16)
    a = JaxLattice(jax_model(name), shape, dtype=jnp.float64,
                   settings=RICH_ONESTAGE_SETTINGS[name])
    b = Lattice(get_model(name), shape, dtype=torch.float64,
                settings=RICH_ONESTAGE_SETTINGS[name], device="cpu")
    for lat in (a, b):
        m = lat.model
        flags = np.full(shape, m.flag_for("MRT"), dtype=np.uint16)
        flags[3, :] = m.flag_for("Wall")
        lat.set_flags(flags)
        lat.init()
        fi = np.zeros(shape)
        fi[0, :] = fi[:, 0] = 1.0
        fi[-1, 5] = fi[5, -1] = 1.0
        lat.set_density("fi_s", fi)
    want = jax_make_iterate(a.model)(_copy(a.state), a.params, 2)
    got = make_iterate(b.model)(b.state, b.params, 2)
    _assert_state(got, want, F64_TOL, F64_TOL)
    fi1 = got.fields[b.model.storage_index["fi_s"]].numpy()
    # the neighbours of the solid row and column grew, across the wrap
    assert fi1[-1, 8] > 0 and fi1[1, 8] > 0 and fi1[6, -1] > 0


def test_solidification_seed_growth():
    """tests/test_physics_constitutive.py's seed growth at 24x24 on the
    port: the Seed starts fully solid, grows monotonically within [0, 1],
    rejects solute (C above the far field) and banks Cs only where
    solid."""
    n = 24
    m = get_model("d2q9_solid")
    lat = Lattice(m, (n, n), dtype=torch.float64, device="cpu", settings={
        "nu": 0.1, "FluidAlfa": 0.05, "SoluteDiffusion": 0.05,
        "C0": 0.5, "Concentration": 0.5, "Temperature": 0.95,
        "T0": 0.95, "Teq": 1.0, "LiquidusSlope": -1.0,
        "PartitionCoef": 0.1})
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[n // 2 - 1:n // 2 + 1, n // 2 - 1:n // 2 + 1] = \
        m.flag_for("MRT", "Seed")
    lat.set_flags(flags)
    lat.init()
    sums = [float(lat.get_quantity("Solid").sum())]
    assert sums[0] == 4.0
    for _ in range(4):
        lat.iterate(15)
        fi = lat.get_quantity("Solid").numpy()
        assert fi.min() >= 0.0 and fi.max() <= 1.0 + 1e-12
        sums.append(float(fi.sum()))
    assert all(y > x for x, y in zip(sums, sums[1:])), sums
    assert sums[-1] > 2 * sums[0]
    assert lat.get_quantity("C").numpy().max() > 0.5 + 1e-4
    cs = lat.get_density("Cs").numpy()
    assert cs.max() > 0.0 and abs(cs[0, 0]) < 1e-12


def test_solidification_curvature_getter():
    """tests/test_physics_constitutive.py's curvature getter: K recovers
    ~1/R on a smooth painted disc (R = 6 on 32x32)."""
    n, r = 32, 6.0
    m = get_model("d2q9_solid")
    lat = Lattice(m, (n, n), dtype=torch.float64, device="cpu",
                  settings={"nu": 0.1, "LiquidusSlope": -1.0})
    lat.set_flags(np.full((n, n), m.flag_for("MRT"), dtype=np.uint16))
    lat.init()
    y, x = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    d = np.sqrt((y - n / 2) ** 2 + (x - n / 2) ** 2)
    lat.set_density("fi_s", np.clip((r + 1.5 - d) / 3.0, 0.0, 1.0))
    k = lat.get_quantity("K").numpy()
    k_mean = float(np.abs(k[np.abs(d - r) < 1.0]).mean())
    assert abs(k_mean - 1.0 / r) / (1.0 / r) < 0.3, k_mean
