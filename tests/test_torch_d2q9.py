"""Model ``d2q9`` on the port's eager engine against the JAX package's XLA
path, on the boundary-rich Kármán flags of ``tests/test_fastpath.py``:
fields and globals after 21 steps at f64 and f32, and the quantities."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from torch_cases import KARMAN_SETTINGS as SETTINGS  # noqa: E402
from torch_cases import karman_flags  # noqa: E402

NITER = 21
# (fields rtol, atol), (globals rtol, atol): f64 at the golden tolerance
# (tests/test_golden.py); f32 at tests/test_fastpath.py's (the two engines
# round differently in the last place)
TOL = {
    "f64": ((1e-10, 1e-12), (1e-10, 1e-12)),
    "f32": ((2e-5, 2e-6), (1e-4, 1e-6)),
}
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def _pair(prec, monkeypatch, ny=64, nx=128):
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    jdt, tdt = DTYPES[prec]
    jm, tm = jax_model("d2q9"), get_model("d2q9")
    flags = karman_flags(tm, ny, nx)
    a = JaxLattice(jm, (ny, nx), dtype=jdt, settings=SETTINGS)
    b = Lattice(tm, (ny, nx), dtype=tdt, settings=SETTINGS, device="cpu")
    for lat in (a, b):
        lat.set_flags(flags)
        lat.init()
    return a, b


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_eager_matches_xla(prec, monkeypatch):
    a, b = _pair(prec, monkeypatch)
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), rtol=0, atol=0,
                               err_msg="Init")
    a.iterate(NITER)
    b.iterate(NITER)
    assert b.engine_name == "eager"
    assert b.state.iteration == int(a.state.iteration) == NITER
    (frt, fat), (grt, gat) = TOL[prec]
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), rtol=frt,
                               atol=fat)
    ga, gb = a.get_globals(), b.get_globals()
    assert list(ga) == list(gb)
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], rtol=grt, atol=gat,
                                   err_msg=f"global {k}")
    assert any(abs(v) > 0 for v in gb.values())
    assert b.get_objective() == pytest.approx(a.get_objective(), abs=1e-12)


def test_quantities(monkeypatch):
    a, b = _pair("f64", monkeypatch, ny=24, nx=40)
    # a body force and a BC coupling plane make U's half-force terms count
    for lat in (a, b):
        lat.set_setting("GravitationX", 1e-4)
    bc = np.random.default_rng(3).uniform(-1e-4, 1e-4, (24, 40))
    a.set_density("BC[0]", bc)
    b.set_density("BC[0]", bc)
    a.iterate(7)
    b.iterate(7)
    for name in ("Rho", "U"):
        got = b.get_quantity(name).numpy()
        want = np.asarray(a.get_quantity(name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(b.get_density("f[5]").numpy(),
                               np.asarray(a.get_density("f[5]")),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.fields_raw()),
                               rtol=1e-10, atol=1e-12)


def test_zonal_settings(monkeypatch):
    """Zonal Velocity/Density reach the boundary nodes through the zone
    bits, as in the JAX package."""
    a, b = _pair("f64", monkeypatch, ny=24, nx=40)
    tm = get_model("d2q9")
    flags = karman_flags(tm, 24, 40)
    flags[:, 0] = tm.flag_for("WVelocity", "MRT", zone=1)
    flags[:, -1] = tm.flag_for("EPressure", "MRT", zone=2)
    for lat in (a, b):
        lat.set_flags(flags)
        lat.set_setting("Velocity", 0.04, zone=1)
        lat.set_setting("Density", 1.01, zone=2)
        lat.init()
        lat.iterate(9)
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(b.params.zone_table.numpy(),
                                  np.asarray(a.params.zone_table))
