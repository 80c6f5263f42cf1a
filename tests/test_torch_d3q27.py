"""Model ``d3q27_cumulant`` in the port against the JAX package: the
registry, the eager step on a flag field that paints every node type (f64
and f32), the quantities and running averages with ``<Average>``, the
painted ``example/3d_channel.xml`` flags, and the 34-plane state crossing
between the packages."""

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

from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.utils import geometry as jax_geometry  # noqa: E402
from tclb_tpu.utils import units as jax_units  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.utils import geometry, units, vtk  # noqa: E402
from torch_cases import (RICH3D_SETTINGS, SHAPE3D, paint_rich_3d,  # noqa: E402
                         rich_flags_3d)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "d3q27_cumulant"
NITER = 5
# (fields rtol, atol), (globals rtol, atol): f64 near the golden tolerance,
# f32 at tests/test_fastpath.py's (the two engines round differently)
TOL = {
    "f64": ((1e-10, 1e-12), (1e-10, 1e-12)),
    "f32": ((2e-5, 2e-6), (1e-4, 1e-6)),
}
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}

# a small forced channel with every handler this model's path uses
AVERAGE_XML = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="32" ny="10" nz="8">
        <MRT><Box/></MRT>
        <Wall mask="ALL"><Channel/></Wall>
    </Geometry>
    <Model>
        <Params nu="0.03" ForceX="0.0001"/>
    </Model>
    <Log Iterations="4"/>
    <VTK Iterations="8"/>
    <Solve Iterations="8"/>
    <Average Iterations="6"/>
    <Solve Iterations="8"/>
</CLBConfig>
"""


def _pair(prec, monkeypatch, seed=1):
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    jdt, tdt = DTYPES[prec]
    a = JaxLattice(jax_model(NAME), SHAPE3D, dtype=jdt,
                   settings=RICH3D_SETTINGS)
    b = Lattice(get_model(NAME), SHAPE3D, dtype=tdt,
                settings=RICH3D_SETTINGS, device="cpu")
    return paint_rich_3d(a, seed), paint_rich_3d(b, seed)


def test_registry_matches():
    j, t = jax_model(NAME), get_model(NAME)
    assert t.storage_names == j.storage_names and t.n_storage == 34
    assert t.groups == j.groups
    np.testing.assert_array_equal(t.ei, j.ei)
    assert [(s.name, s.zonal, s.default) for s in t.settings] == \
        [(s.name, s.zonal, s.default) for s in j.settings]
    np.testing.assert_array_equal(t.settings_vector({"nu": 0.01}),
                                  j.settings_vector({"nu": 0.01}))
    assert t.group_masks == j.group_masks
    assert (t.zone_shift, t.zone_max) == (j.zone_shift, j.zone_max)
    for name, nt in j.node_types.items():
        got = t.node_types[name]
        assert (got.group, got.value, got.mask) == \
            (nt.group, nt.value, nt.mask), name
    for names, zone in ((("MRT",), 0), (("WVelocityTurbulent", "MRT"), 3),
                        (("NSymmetry", "MRT", "Buffer"), 1),
                        (("SPressure", "BGK", "Outlet"), 2)):
        assert t.flag_for(*names, zone=zone) == j.flag_for(*names, zone=zone)
    assert [d.average for d in t.densities] == \
        [d.average for d in j.densities]
    assert t.structural_key() == j.structural_key()
    assert t.fingerprint == j.fingerprint


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_eager_matches_xla(prec, monkeypatch):
    """Five steps on the every-node-type flags: fields (populations,
    SynthT and both averages) and the Flux global."""
    a, b = _pair(prec, monkeypatch)
    np.testing.assert_array_equal(b.state.fields.numpy(),
                                  np.asarray(a.state.fields))
    a.iterate(NITER)
    b.iterate(NITER)
    assert b.engine_name == "eager"
    assert b.state.iteration == int(a.state.iteration) == NITER
    (frt, fat), (grt, gat) = TOL[prec]
    m = b.model
    for group in ("f", "SynthT", "avg", "avgU"):
        idx = list(m.groups[group])
        np.testing.assert_allclose(b.state.fields.numpy()[idx],
                                   np.asarray(a.state.fields)[idx],
                                   rtol=frt, atol=fat, err_msg=group)
    ga, gb = a.get_globals(), b.get_globals()
    assert list(ga) == list(gb) == ["Flux"]
    np.testing.assert_allclose(gb["Flux"], ga["Flux"], rtol=grt, atol=gat)
    assert gb["Flux"] > 0


def test_quantities_and_reset_average(monkeypatch):
    a, b = _pair("f64", monkeypatch, seed=2)
    for lat in (a, b):
        lat.iterate(NITER)
        lat.reset_average()
        lat.iterate(NITER)
    assert b.avg_start == a.avg_start == NITER
    for name in ("Rho", "U", "P", "avgU", "averageP"):
        got = b.get_quantity(name).numpy()
        want = np.asarray(a.get_quantity(name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    # NITER samples since the reset
    np.testing.assert_allclose(
        b.get_quantity("averageP").numpy() * NITER,
        b.get_density("avgP").numpy(), rtol=1e-13)


def _paint(pkg_geometry, pkg_units, model, xml_path):
    node = ET.parse(xml_path).getroot().find("Geometry")
    env = pkg_units.UnitEnv()
    shape = tuple(int(env.alt(node.get(a))) for a in ("nz", "ny", "nx"))
    geo = pkg_geometry.Geometry(model, shape, env)
    geo.load(node)
    return geo.result(), geo.setting_zones


def test_3d_channel_xml_paints_the_same_flags():
    """example/3d_channel.xml at its full 48x48x256, bit for bit."""
    xml = ROOT / "example" / "3d_channel.xml"
    got, zones = _paint(geometry, units, get_model(NAME), xml)
    want, jzones = _paint(jax_geometry, jax_units, jax_model(NAME), xml)
    assert got.shape == (48, 48, 256) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert zones == jzones
    m = get_model(NAME)
    assert (got[:, 0, :] == m.flag_for("Wall")).all()
    assert (got[:, 1:-1, :] == m.flag_for("MRT")).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_state_crosses_both_ways(dtype, monkeypatch):
    """A JAX d3q27_cumulant state with its params into the port and back,
    bit-exact, and into a port Lattice."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    a = paint_rich_3d(JaxLattice(jax_model(NAME), SHAPE3D, dtype=jdt,
                                 settings=RICH3D_SETTINGS), 3)
    a.state = a.state.__class__(fields=a.state.fields, flags=a.state.flags,
                                globals_=a.state.globals_ + 0.5,
                                iteration=jnp.int32(2))
    s, p = a.state, a.params
    state, params = state_from_numpy(
        get_model(NAME), np.asarray(s.fields), np.asarray(s.flags),
        np.asarray(s.globals_), np.asarray(s.iteration),
        np.asarray(p.settings), np.asarray(p.zone_table), device="cpu")
    assert state.fields.shape == (34,) + SHAPE3D
    back = state_to_numpy(state, params)
    for key, want in (("fields", s.fields), ("flags", s.flags),
                      ("globals_", s.globals_), ("settings", p.settings),
                      ("zone_table", p.zone_table)):
        assert back[key].dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(back[key], np.asarray(want),
                                      err_msg=key)
    assert int(back["iteration"]) == 2
    b = Lattice(get_model(NAME), SHAPE3D, dtype=state.fields.dtype,
                device="cpu")
    b.set_state(state, params)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(s.fields, dtype=np.float64))
    np.testing.assert_array_equal(b.flags_numpy(), np.asarray(s.flags))


def test_average_handler_and_outputs_match(tmp_path):
    """<Average>, <Log> and 3D <VTK> through both control planes: the
    same files, the same log rows and the same averaged state."""
    runs = []
    for run_root, model, dtype, tag in (
            (solver._run_root, get_model(NAME), torch.float64, "port"),
            (jax_solver._run_root, jax_model(NAME), jnp.float64, "ref")):
        out = tmp_path / tag
        kw = {"device": "cpu"} if tag == "port" else {}
        s = run_root(ET.fromstring(AVERAGE_XML.format(out=out)), model,
                     None, dtype, str(out) + "/", "a", **kw)
        runs.append((s, out))
    (port, pout), (ref, rout) = runs
    assert port.iter == ref.iter == 16
    assert port.lattice.avg_start == ref.lattice.avg_start == 14
    names = sorted(p.name for p in pout.iterdir())
    assert names == sorted(p.name for p in rout.iterdir())
    assert "a_VTK_00000016.vti" in names
    assert vtk.csvdiff(str(pout / "a_Log.csv"), str(rout / "a_Log.csv"),
                       tol=1e-10) == []
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               rtol=1e-10, atol=1e-12)
    for q in ("avgU", "averageP"):
        np.testing.assert_allclose(port.lattice.get_quantity(q).numpy(),
                                   np.asarray(ref.lattice.get_quantity(q)),
                                   rtol=1e-10, atol=1e-12, err_msg=q)


def test_rich_flags_paint_every_case():
    """The test flags reach every boundary case, the Buffer layer and both
    collision types (so the comparisons above cover them all)."""
    from tclb_tpu_torch.ops.d3q27_kernels import CASES
    m = get_model(NAME)
    flags = rich_flags_3d(m, *SHAPE3D).astype(np.int64)
    for name in CASES[NAME] + ("Buffer", "MRT", "BGK", "WPressureL",
                               "Inlet", "Outlet"):
        t = m.node_types[name]
        assert ((flags & t.mask) == t.value).any(), name
