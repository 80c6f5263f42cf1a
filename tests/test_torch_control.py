"""The port's control plane against the JAX package's: geometry painting,
units, CSV/VTI output, the handler tree and the CLI, and each slice as a
whole — the d2q9, channel3d, drop and heat_adj goldens reproduced through
the port's ``_run_root``, and example/cavity.xml and heat_channel.xml run
through both packages."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import json  # noqa: E402
import pathlib  # noqa: E402
import xml.etree.ElementTree as ET  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.utils import geometry as jax_geometry  # noqa: E402
from tclb_tpu.utils import units as jax_units  # noqa: E402
from tclb_tpu.utils import vtk as jax_vtk  # noqa: E402
from tclb_tpu_torch import __main__ as cli  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.models import get_model  # noqa: E402
from tclb_tpu_torch.utils import geometry, units, vtk  # noqa: E402
from torch_cases import heat_adj_golden_columns  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "tests" / "goldens"
RTOL, ATOL = 1e-10, 1e-12     # tests/test_golden.py's csvdiff model

# tests/test_golden.py's two d2q9 cases, verbatim
KARMAN = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="64" ny="32">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Inlet/></WVelocity>
        <EPressure name="Outlet"><Outlet/></EPressure>
        <Inlet nx='1' dx='2'><Box/></Inlet>
        <Outlet nx='1' dx='-2'><Box/></Outlet>
        <Wall mask="ALL">
            <Channel/>
            <Wedge dx="12" nx="4" dy="18" ny="4" direction="LowerRight"/>
            <Wedge dx="12" nx="4" dy="10" ny="4" direction="UpperRight"/>
        </Wall>
    </Geometry>
    <Model>
        <Params Velocity="0.05"/>
        <Params nu="0.05"/>
    </Model>
    <Solve Iterations="200"/>
</CLBConfig>
"""

POISEUILLE = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Units>
        <Params size="0.0005m" gauge="1"/>
        <Params nu="1e-5m2/s" gauge="0.1666666666"/>
    </Units>
    <Geometry nx="0.02m" ny="0.0105m">
        <MRT><Box/></MRT>
        <Wall mask="ALL"><Channel/></Wall>
    </Geometry>
    <Model>
        <Params Velocity="0.0"/>
        <Params omega="1.0"/>
        <Params GravitationX="0.000311634m/s2"/>
        <Params Density="1000kg/m3"/>
    </Model>
    <Solve Iterations="500"/>
</CLBConfig>
"""

# tests/test_golden.py's d3q27_cumulant forced channel, verbatim
CHANNEL3D = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="48" ny="16" nz="16">
        <MRT><Box/></MRT>
        <Wall mask="ALL"><Channel/></Wall>
    </Geometry>
    <Model>
        <Params nu="0.02"/>
        <Params ForceX="0.00001" ForceZ="-0.00003"/>
    </Model>
    <Solve Iterations="200"/>
</CLBConfig>
"""
# tests/test_golden.py's d2q9_kuper drop, verbatim
DROP = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="64" ny="64">
        <MRT><Box/></MRT>
        <None name="zdrop">
            <Sphere dx="20" nx="24" dy="20" ny="24"/>
        </None>
    </Geometry>
    <Model>
        <Params omega="1"/>
        <!-- the REAL drop.xml parameters (225x density ratio), reduced
             from 512^2/500k to 64^2/300 -->
        <Params Density="3.2600529440452366"
                Density-zdrop="0.014500641645077492"
                Temperature="0.56" FAcc="1" Magic="0.01"
                MagicA="-0.152" MagicF="-0.6666666666666"/>
    </Model>
    <Solve Iterations="300"/>
</CLBConfig>
"""
# tests/test_golden.py's d2q9_heat_adj case, verbatim
HEAT_ADJ = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="32" ny="16">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Box nx="1"/></WVelocity>
        <EPressure name="Outlet"><Box dx="-1"/></EPressure>
        <Wall mask="ALL"><Channel/></Wall>
        <DesignSpace><Box dx="8" nx="16"/></DesignSpace>
    </Geometry>
    <Model>
        <Params InletVelocity="0.02" nu="0.05"/>
        <Params InletTemperature="1" InitTemperature="0"/>
        <Params FluidAlfa="0.05" SolidAlfa="0.005"/>
    </Model>
    <Solve Iterations="150"/>
</CLBConfig>
"""
# the model each golden case runs
GOLDEN_MODELS = {"karman": "d2q9", "poiseuille": "d2q9",
                 "channel3d": "d3q27_cumulant", "drop": "d2q9_kuper",
                 "heat_adj": "d2q9_heat_adj"}

# every handler of the slice on a small case: Log, VTK, Stop, Failcheck,
# Repeat, Init and zonal Params, run through both packages
HANDLERS = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="48" ny="20">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Inlet/></WVelocity>
        <EPressure name="Outlet"><Outlet/></EPressure>
        <Inlet nx='1' dx='2'><Box/></Inlet>
        <Outlet nx='1' dx='-2'><Box/></Outlet>
        <Wall mask="ALL">
            <Channel/>
            <Wedge dx="10" nx="4" dy="10" ny="4" direction="LowerRight"/>
        </Wall>
    </Geometry>
    <Model>
        <Params Velocity="0.02" Velocity-Inlet="0.03" nu="0.05"/>
        <Params Density-Outlet="1.001"/>
    </Model>
    <Log Iterations="25"/>
    <VTK Iterations="60" what="U,Rho"/>
    <Failcheck Iterations="40"/>
    <Repeat Times="2">
        <Solve Iterations="70"/>
        <Init/>
    </Repeat>
    <Stop InletFluxChange="1e-9" Times="2" Iterations="10"/>
    <Solve Iterations="50"/>
</CLBConfig>
"""


def _geometry_flags(pkg_geometry, pkg_units, model, xml_path):
    root = ET.parse(xml_path).getroot()
    node = root.find("Geometry")
    env = pkg_units.UnitEnv()
    shape = (int(env.alt(node.get("ny"))), int(env.alt(node.get("nx"))))
    geo = pkg_geometry.Geometry(model, shape, env)
    geo.load(node)
    return geo.result(), geo.setting_zones


def test_karman_xml_paints_the_same_flags():
    """example/karman.xml at its full 1024x100, bit for bit."""
    xml = ROOT / "example" / "karman.xml"
    got, zones = _geometry_flags(geometry, units, get_model("d2q9"), xml)
    want, jzones = _geometry_flags(jax_geometry, jax_units,
                                   jax_model("d2q9"), xml)
    assert got.shape == (100, 1024) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert zones == jzones
    assert len(np.unique(got)) > 4


def test_units_gauge_poiseuille():
    root = ET.fromstring(POISEUILLE.format(out="unused"))
    envs = []
    for pkg in (units, jax_units):
        env = pkg.UnitEnv()
        for p in root.find("Units").findall("Params"):
            (name, value), = [(k, v) for k, v in p.attrib.items()
                              if k != "gauge"]
            env.set_unit(name, env.read_text(value),
                         float(env.si(p.get("gauge"))))
        env.make_gauge()
        envs.append(env)
    port, ref = envs
    np.testing.assert_allclose(port.scale, ref.scale, rtol=1e-14)
    for text in ("0.02m", "0.0105m", "1e-5m2/s", "0.000311634m/s2",
                 "1000kg/m3", "1s", "2ms", "1m+10cm", "3.5", "1N/m2"):
        assert port.alt(text) == pytest.approx(ref.alt(text), rel=1e-14), \
            text
        if "+" not in text:     # si() reads one term; alt() reads sums
            assert port.si(text) == ref.si(text), text


def test_vti_pvti_and_csv_bytes(tmp_path):
    rng = np.random.default_rng(7)
    arrays = {"Rho": rng.random((6, 9)).astype(np.float32),
              "U": rng.random((3, 6, 9)).astype(np.float32),
              "Flag": rng.integers(0, 2 ** 16, (6, 9)).astype(np.uint16)}
    outs = []
    for pkg, tag in ((vtk, "port"), (jax_vtk, "ref")):
        d = tmp_path / tag
        piece = pkg.write_vti(str(d / "a.vti"), arrays)
        pkg.write_pvti(str(d / "a.pvti"), piece, arrays)
        log = pkg.CSVLog(str(d / "log.csv"))
        for i in range(3):
            log.write({"Iteration": float(i), "x": 0.1 * i, "y": 1e-17 * i})
        outs.append([(d / n).read_bytes()
                     for n in ("a.vti", "a.pvti", "log.csv")])
    assert outs[0] == outs[1]


def test_handler_tree_matches(tmp_path):
    """The same case through both control planes: the same log rows, the
    same output files and the same final state."""
    runs = []
    for run_root, model, dtype, tag in (
            (solver._run_root, get_model("d2q9"), torch.float64, "port"),
            (jax_solver._run_root, jax_model("d2q9"), jnp.float64, "ref")):
        out = tmp_path / tag
        kw = {"device": "cpu"} if tag == "port" else {}
        s = run_root(ET.fromstring(HANDLERS.format(out=out)), model, None,
                     dtype, str(out) + "/", "h", **kw)
        runs.append((s, out))
    (port, pout), (ref, rout) = runs
    assert port.iter == ref.iter
    names = sorted(p.name for p in pout.iterdir())
    assert names == sorted(p.name for p in rout.iterdir())
    assert any(n.endswith(".pvti") for n in names)
    assert vtk.csvdiff(str(pout / "h_Log.csv"), str(rout / "h_Log.csv"),
                       tol=1e-10) == []
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("old,new", [
    ('<Solve Iterations="200"/>', '<SaveBinary file="x"/>'),
    ('<Channel/>', '<HalfSphere dx="20" nx="8" dy="10" ny="8"/>'),
])
def test_unported_handler_names_its_roadmap_item(tmp_path, old, new):
    xml = KARMAN.format(out=tmp_path).replace(old, new)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        solver.run_config_string(xml, get_model("d2q9"),
                                 dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name,xml", [("karman", KARMAN),
                                      ("poiseuille", POISEUILLE),
                                      ("channel3d", CHANNEL3D),
                                      ("drop", DROP),
                                      ("heat_adj", HEAT_ADJ)])
def test_golden_through_port(name, xml, tmp_path):
    """tests/goldens/<name>.json through the port's _run_root at f64 on
    the CPU: same column set, RTOL 1e-10 / ATOL 1e-12; heat_adj adds the
    gradient columns of tests/test_golden.py (the adjoint slice)."""
    s = solver._run_root(ET.fromstring(xml.format(out=tmp_path)),
                         get_model(GOLDEN_MODELS[name]), None,
                         torch.float64, str(tmp_path) + "/", name,
                         device="cpu")
    row = s.log_row()
    fields = s.lattice.state.fields.numpy()
    row["FieldsL1"] = float(np.abs(fields).sum())
    row["FieldsSum"] = float(fields.sum())
    if name == "heat_adj":
        cols, engine = heat_adj_golden_columns(s)
        assert engine == "eager"
        row.update(cols)
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    assert set(golden) == set(row), set(golden) ^ set(row)
    for key, want in golden.items():
        if key == "Walltime":
            continue
        assert abs(row[key] - want) <= ATOL + RTOL * abs(want), \
            f"{name}:{key}: {row[key]!r} != {want!r}"


def _read_log(path):
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


# the examples run through both control planes, each cut to this many
# iterations with a Log every quarter of them
EXAMPLE_CUTS = {"cavity.xml": 200, "heat_channel.xml": 200,
                "karman_control.xml": 500, "sw_wave.xml": 200,
                "solidification.xml": 200, "npe_guo.xml": 200,
                "bubble_rise.xml": 20, "mcmp_contact.xml": 200,
                "drop_lee.xml": 200}


@pytest.mark.parametrize("example", list(EXAMPLE_CUTS))
def test_example_through_both_control_planes(example, tmp_path,
                                             monkeypatch):
    """example/cavity.xml (d2q9_kuper, a MovingWall lid),
    example/heat_channel.xml (d2q9_heat, a Heater strip),
    example/karman_control.xml (d2q9 under a <Control> inlet ramp read
    from example/inlet_ramp.csv, which the XML names relative to the
    repository's root), example/sw_wave.xml (sw, a Height-zhump zone),
    example/solidification.xml (d2q9_solid, a Seed),
    example/npe_guo.xml (d2q9_npe_guo, charged walls),
    example/bubble_rise.xml (d2q9_pf_pressureEvolution, a rising bubble),
    example/mcmp_contact.xml (d2q9_pp_MCMP, two components) and
    example/drop_lee.xml (d2q9_lee, a drop in its vapour) through both
    packages' _run_root at f64, cut to
    EXAMPLE_CUTS iterations with four Log rows: the fields and every Log
    column at RTOL 1e-10 / ATOL 1e-12."""
    niter = EXAMPLE_CUTS[example]
    monkeypatch.chdir(ROOT)
    port, ref = _run_both(example, niter, tmp_path)
    assert port.lattice.params.series_map == ref.lattice.params.series_map
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               rtol=RTOL, atol=ATOL)


def _run_both(example, niter, tmp_path):
    """``example`` cut to ``niter`` iterations, a Log every quarter of
    them and no VTK, through both packages' _run_root at f64: the two
    solvers, after their Log files were held against each other (every
    column but Walltime at RTOL / ATOL)."""
    root = ET.parse(ROOT / "example" / example).getroot()
    root.find("Solve").set("Iterations", str(niter))
    root.find("Log").set("Iterations", str(niter // 4))
    for el in root.findall("VTK"):
        root.remove(el)
    runs = {}
    for tag, run_root, get, dtype in (
            ("port", solver._run_root, get_model, torch.float64),
            ("ref", jax_solver._run_root, jax_model, jnp.float64)):
        out = tmp_path / tag
        root.set("output", str(out) + "/")    # the XML's own wins
        kw = {"device": "cpu"} if tag == "port" else {}
        runs[tag] = (run_root(root, get(root.get("model")), None, dtype,
                              str(out) + "/", "case", **kw), out)
    (port, pout), (ref, rout) = runs["port"], runs["ref"]
    assert port.iter == ref.iter == niter
    hp, lp = _read_log(pout / "case_Log.csv")
    hr, lr = _read_log(rout / "case_Log.csv")
    assert hp == hr and lp.shape == lr.shape == (4, len(hp))
    keep = [i for i, h in enumerate(hp) if h != "Walltime"]
    np.testing.assert_allclose(lp[:, keep], lr[:, keep], rtol=RTOL,
                               atol=ATOL)
    return port, ref


def test_bubble_rise_conserves_like_reference(tmp_path, monkeypatch):
    """example/bubble_rise.xml at 200 iterations through both packages:
    past the 20 iterations EXAMPLE_CUTS holds its fields for, one ulp of
    the interface normal grows to order 0.1 in either package, so what is
    held is what does not depend on it: every Log column, the PhaseField
    sum of each package within 1e-12 of the initial one (chip_smoke.py's
    PF_SUM_F64) and of the other's, and TotalDensity the sum of Rho over
    the MRT nodes."""
    monkeypatch.chdir(ROOT)
    root = ET.parse(ROOT / "example" / "bubble_rise.xml").getroot()
    for tag in ("Solve", "Log"):
        root.remove(root.find(tag))
    root.set("output", str(tmp_path / "start") + "/")
    start = solver._run_root(root, get_model(root.get("model")), None,
                             torch.float64, str(tmp_path / "start") + "/",
                             "case", device="cpu").lattice
    phase0 = float(start.get_quantity("PhaseField").sum())
    sums = []
    for run in _run_both("bubble_rise.xml", 200, tmp_path):
        lat = run.lattice
        flags = np.asarray(lat.state.flags).astype(np.int64)
        mrt = lat.model.node_types["MRT"]
        rho = np.asarray(lat.get_quantity("Rho"))
        assert lat.get_globals()["TotalDensity"] == pytest.approx(
            float(rho[(flags & mrt.mask) == mrt.value].sum()), rel=RTOL)
        sums.append(float(np.asarray(lat.get_quantity("PhaseField")).sum()))
    for got in sums:
        assert abs(got - phase0) <= 1e-12 * abs(phase0)
    assert abs(sums[0] - sums[1]) <= 1e-12 * abs(sums[1])


def test_cli(tmp_path, capsys):
    case = tmp_path / "k.xml"
    case.write_text(KARMAN.replace("<CLBConfig ", '<CLBConfig model="d2q9" ')
                    .replace('Iterations="200"', 'Iterations="16"')
                    .format(out=tmp_path / "out"))
    assert cli.main(["run", str(case), "--device", "cpu",
                     "--precision", "f64"]) == 0
    assert "done: 16 iterations on cpu (engine eager)" in capsys.readouterr().out
    assert (tmp_path / "out" / "k_config.xml").exists()
    assert cli.main(["models"]) == 0
    assert capsys.readouterr().out.split() == [
        "d2q9", "d2q9_SRT", "d2q9_adj", "d2q9_cumulant", "d2q9_diff",
        "d2q9_hb", "d2q9_heat", "d2q9_heat_adj", "d2q9_heat_conjugate",
        "d2q9_inc", "d2q9_kuper", "d2q9_kuper_adj", "d2q9_lee", "d2q9_les",
        "d2q9_new", "d2q9_npe_guo", "d2q9_optimalMixing", "d2q9_pf",
        "d2q9_pf_curvature", "d2q9_pf_pressureEvolution", "d2q9_plate",
        "d2q9_poison_boltzmann", "d2q9_pp_LBL", "d2q9_pp_MCMP",
        "d2q9_solid", "d3q19", "d3q19_adj", "d3q19_heat", "d3q19_heat_adj",
        "d3q19_heat_adj_art", "d3q19_heat_adj_prop", "d3q19_kuper",
        "d3q19_les", "d3q27", "d3q27_BGK", "d3q27_BGK_galcor",
        "d3q27_cumulant", "d3q27_cumulant_qibb_small", "d3q27_viscoplastic",
        "sw", "wave", "wave2d"]
    assert cli.main(["describe", "d2q9"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["densities"][-2:] == ["BC[0]", "BC[1]"]
