"""Model ``d2q9_kuper`` in the port against the JAX package: the registry,
the eager two-stage step on a walled flag field that paints every node type
(f64 and f32), the quantities (``F`` reaches the neighbours' ``phi``
through ``ctx.load``), the painted ``example/drop.xml`` flags (``<Sphere>``
and the ``zdrop`` zone), and the 10-plane state crossing between the
packages."""

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
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.utils import geometry as jax_geometry  # noqa: E402
from tclb_tpu.utils import units as jax_units  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.utils import geometry, units  # noqa: E402
from torch_cases import (KUPER_SETTINGS, KUPER_SHAPE,  # noqa: E402
                         paint_rich_kuper)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "d2q9_kuper"
NITER = 5
# (fields rtol, atol), (globals rtol, atol): f64 at the golden tolerance,
# f32 at tests/test_fastpath.py's (the two engines round differently)
TOL = {
    "f64": ((1e-10, 1e-12), (1e-10, 1e-12)),
    "f32": ((2e-5, 2e-6), (1e-4, 1e-6)),
}
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def _pair(prec, monkeypatch, seed=1):
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    jdt, tdt = DTYPES[prec]
    a = JaxLattice(jax_model(NAME), KUPER_SHAPE, dtype=jdt,
                   settings=KUPER_SETTINGS)
    b = Lattice(get_model(NAME), KUPER_SHAPE, dtype=tdt,
                settings=KUPER_SETTINGS, device="cpu")
    return paint_rich_kuper(a, seed), paint_rich_kuper(b, seed)


def test_registry_matches():
    j, t = jax_model(NAME), get_model(NAME)
    assert t.storage_names == j.storage_names and t.n_storage == 10
    assert t.groups == j.groups
    np.testing.assert_array_equal(t.ei, j.ei)
    assert [(f.name, f.dx_range, f.dy_range) for f in t.fields] == \
        [(f.name, f.dx_range, f.dy_range) for f in j.fields]
    assert [(s.name, s.zonal, s.default) for s in t.settings] == \
        [(s.name, s.zonal, s.default) for s in j.settings]
    np.testing.assert_array_equal(t.settings_vector({"nu": 0.1}),
                                  j.settings_vector({"nu": 0.1}))
    assert t.group_masks == j.group_masks
    assert (t.zone_shift, t.zone_max) == (j.zone_shift, j.zone_max)
    for name, nt in j.node_types.items():
        got = t.node_types[name]
        assert (got.group, got.value, got.mask) == \
            (nt.group, nt.value, nt.mask), name
    assert t.actions == j.actions
    assert t.structural_key() == j.structural_key()
    assert t.fingerprint == j.fingerprint


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_eager_matches_xla(prec, monkeypatch):
    """Five Iterations (Run, then CalcPhi) on the walled flags: every
    plane, phi included, and the wall-force globals."""
    a, b = _pair(prec, monkeypatch)
    (frt, fat), (grt, gat) = TOL[prec]
    np.testing.assert_allclose(b.fields_raw(), a.fields_raw(), rtol=frt,
                               atol=fat)
    a.iterate(NITER)
    b.iterate(NITER)
    assert b.engine_name == "eager" and b.eager_steps == NITER
    assert b.state.iteration == int(a.state.iteration)
    np.testing.assert_allclose(b.fields_raw(), a.fields_raw(), rtol=frt,
                               atol=fat)
    ga, gb = a.get_globals(), b.get_globals()
    assert list(ga) == list(gb) == ["WallForceX", "WallForceY"]
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], rtol=grt, atol=gat,
                                   err_msg=k)
    assert abs(gb["WallForceY"]) > 0


def test_quantities(monkeypatch):
    a, b = _pair("f64", monkeypatch, seed=2)
    for lat in (a, b):
        lat.iterate(NITER)
    for name in ("Rho", "U", "P", "F"):
        got = b.get_quantity(name).numpy()
        want = np.asarray(a.get_quantity(name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_load_reaches_the_neighbour():
    """``ctx.load(name, dx, dy)`` is the value at ``x + (dx, dy)`` of the
    un-streamed storage, periodic."""
    from tclb_tpu_torch.core.lattice import NodeCtx
    m = get_model(NAME)
    lat = Lattice(m, (4, 6), dtype=torch.float64, device="cpu")
    phi = torch.arange(24, dtype=torch.float64).reshape(4, 6)
    lat.set_density("phi", phi.numpy())
    f = lat.state.fields
    ctx = NodeCtx(m, f, f, lat.state.flags, lat.params)
    assert torch.equal(ctx.load("phi"), phi)
    for dx, dy in ((1, 0), (0, 1), (-1, 1), (1, -1)):
        want = torch.roll(phi, (-dy, -dx), (0, 1))
        assert torch.equal(ctx.load("phi", dx, dy), want)
        assert ctx.load("phi", dx, dy)[1, 2] == phi[1 + dy, 2 + dx]


def _paint(pkg_geometry, pkg_units, model, xml_path):
    node = ET.parse(xml_path).getroot().find("Geometry")
    env = pkg_units.UnitEnv()
    shape = (int(env.alt(node.get("ny"))), int(env.alt(node.get("nx"))))
    geo = pkg_geometry.Geometry(model, shape, env)
    geo.load(node)
    return geo.result(), geo.setting_zones


def test_drop_xml_paints_the_same_flags():
    """example/drop.xml at its full 128x128: the <Sphere> painting the
    zdrop zone, bit for bit."""
    xml = ROOT / "example" / "drop.xml"
    got, zones = _paint(geometry, units, get_model(NAME), xml)
    want, jzones = _paint(jax_geometry, jax_units, jax_model(NAME), xml)
    assert got.shape == (128, 128) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert zones == jzones == {"DefaultZone": 0, "zdrop": 1}
    m = get_model(NAME)
    inside = got == m.flag_for("MRT", zone=1)
    assert (got[~inside] == m.flag_for("MRT")).all()
    # the disc of diameter 48 at (40..87, 40..87): 1804 node centres
    assert inside.sum() == 1804 and inside[63, 63] and not inside[40, 40]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_state_crosses_both_ways(dtype, monkeypatch):
    """A JAX d2q9_kuper state (f[0..8], then phi) with its params into the
    port and back, bit-exact, and into a port Lattice."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    a = paint_rich_kuper(JaxLattice(jax_model(NAME), KUPER_SHAPE, dtype=jdt,
                                    settings=KUPER_SETTINGS), 3)
    a.iterate(2)
    s, p = a.state, a.params
    state, params = state_from_numpy(
        get_model(NAME), np.asarray(s.fields), np.asarray(s.flags),
        np.asarray(s.globals_), np.asarray(s.iteration),
        np.asarray(p.settings), np.asarray(p.zone_table), device="cpu")
    assert state.fields.shape == (10,) + KUPER_SHAPE
    back = state_to_numpy(state, params)
    for key, want in (("fields", s.fields), ("flags", s.flags),
                      ("globals_", s.globals_), ("settings", p.settings),
                      ("zone_table", p.zone_table)):
        assert back[key].dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(back[key], np.asarray(want),
                                      err_msg=key)
    assert int(back["iteration"]) == int(s.iteration)
    b = Lattice(get_model(NAME), KUPER_SHAPE, dtype=state.fields.dtype,
                device="cpu")
    b.set_state(state, params)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(s.fields, dtype=np.float64))
    np.testing.assert_array_equal(b.flags_numpy(), np.asarray(s.flags))
    np.testing.assert_array_equal(b.get_density("phi").numpy(),
                                  np.asarray(s.fields)[9])
