"""The <Sample> point sampler and the <Keep> feedback loop in the port
against the JAX package: ``make_sampled_iterate``, the sampler's CSV
through both control planes (column names letter for letter), the
sampled engine's tag, and <Keep>'s weight trajectory."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import xml.etree.ElementTree as ET  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.core import lattice as jax_lattice  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.core import lattice  # noqa: E402
from tclb_tpu_torch.utils.sampler import Sampler  # noqa: E402
from torch_cases import (ADJ3D_SETTINGS, ADJ3D_SHAPE,  # noqa: E402
                         RICH_SETTINGS, add_rich_series, paint_rich,
                         paint_rich_adj3d)

RTOL, ATOL = 1e-10, 1e-12      # tests/test_golden.py's csvdiff model

# a d2q9 channel with objective columns, <Sample> probes at three points
SAMPLED = """<?xml version="1.0"?>
<CLBConfig version="2.0" output="{out}/">
    <Geometry nx="64" ny="24">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Inlet/></WVelocity>
        <EPressure name="Outlet"><Outlet/></EPressure>
        <Inlet nx='1' dx='2'><Box/></Inlet>
        <Outlet nx='1' dx='-2'><Box/></Outlet>
        <Wall mask="ALL"><Channel/>
            <Box dx="12" nx="4" dy="10" ny="4"/></Wall>
    </Geometry>
    <Model><Params Velocity="0.03" nu="0.05"/></Model>
    {control}
    <Sample what="{what}" Iterations="{every}">
        <Point dx="5" dy="6"/><Point dx="30" dy="12"/>
        <Point dx="62" dy="20"/>
    </Sample>
    <Log Iterations="10"/>
    <Solve Iterations="30"/>
</CLBConfig>
"""
CONTROL = """<Control Iterations="16">
        <CSV file="{csv}"/><Params Velocity-Inlet="vel"/></Control>"""

# d2q9 with <Keep> on InletFlux: the weight InletFluxInObj moves each
# firing and the Log records it
KEPT = SAMPLED.replace(
    '<Sample what="{what}" Iterations="{every}">', "").replace(
    """        <Point dx="5" dy="6"/><Point dx="30" dy="12"/>
        <Point dx="62" dy="20"/>
    </Sample>""", '<Keep What="InletFlux" {mode}="{target}" Rate="{rate}" '
    'Iterations="5"/>').replace('<Log Iterations="10"/>',
                                '<Log Iterations="5"/>')


def _read(path):
    lines = path.read_text().strip().split("\n")
    return lines[0], np.array([[float(v) for v in r.split(",")]
                               for r in lines[1:]])


def _both(xml, tmp_path, model="d2q9"):
    runs = {}
    for tag, run_root, get, dtype in (
            ("port", solver._run_root, get_model, torch.float64),
            ("ref", jax_solver._run_root, jax_model, jnp.float64)):
        out = tmp_path / tag
        kw = {"device": "cpu"} if tag == "port" else {}
        runs[tag] = (run_root(ET.fromstring(xml.format(out=out)),
                              get(model), None, dtype, str(out) + "/",
                              "case", **kw), out)
    return runs


@pytest.mark.parametrize("what,every,control", [
    ("U,Rho", 10, False),
    ("all", 7, False),
    ("Rho", 10, True),
])
def test_sample_csv_matches_reference(what, every, control, tmp_path,
                                      monkeypatch):
    """The Sample CSV through both packages' _run_root at f64: the same
    header letter for letter, one row per iteration, the same values
    (written with %g), and the same final state; with a <Control> series
    as well.  The port runs the sampled steps eager by selection."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "r.csv").write_text("vel\n0.01\n0.04\n0.02\n")
    xml = SAMPLED.format(out="{out}", what=what, every=every,
                         control=CONTROL.format(csv="r.csv")
                         if control else "")
    runs = _both(xml, tmp_path)
    (port, pout), (ref, rout) = runs["port"], runs["ref"]
    hp, vp = _read(pout / "case_Sample.csv")
    hr, vr = _read(rout / "case_Sample.csv")
    assert hp == hr
    assert vp.shape == vr.shape == (30, len(hp.split(",")))
    np.testing.assert_array_equal(vp[:, 0], np.arange(1, 31))
    np.testing.assert_allclose(vp, vr, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               rtol=RTOL, atol=ATOL)
    assert port.lattice.sampler is None       # detached when Solve ended
    assert port.lattice.eager_steps == 30


@pytest.mark.parametrize("name", ["d2q9", "d3q19_adj"])
def test_sampled_iterate_matches_reference(name):
    """make_sampled_iterate on a rich state with series on two zones:
    every step's samples and the last step's globals at f64."""
    shape, settings, paint = {
        "d2q9": ((24, 48), RICH_SETTINGS, paint_rich),
        "d3q19_adj": (ADJ3D_SHAPE, ADJ3D_SETTINGS, paint_rich_adj3d)}[name]
    a = add_rich_series(paint(JaxLattice(jax_model(name), shape,
                                         dtype=jnp.float64,
                                         settings=settings), 3))
    b = add_rich_series(paint(Lattice(get_model(name), shape,
                                      dtype=torch.float64,
                                      settings=settings, device="cpu"), 3))
    points = np.array([[1] * (len(shape) - 2) + [2, 3],
                       [0] * (len(shape) - 2) + [shape[-2] - 1, 7],
                       [2] * (len(shape) - 2) + [5, shape[-1] - 1]])
    quants = [q.name for q in b.model.quantities if not q.adjoint]
    st, got = lattice.make_sampled_iterate(b.model, points, quants)(
        b.state, b.params, 8, 2)
    ws, want = jax_lattice.make_sampled_iterate(a.model, points, quants)(
        a.state, a.params, 8, 2)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.globals_.numpy(), np.asarray(ws.globals_),
                               rtol=RTOL, atol=ATOL)
    assert st.iteration == int(ws.iteration)


def test_sampler_runs_eager_by_selection(tmp_path):
    """While a sampler is attached the engine tag is sampled_eager and
    every step is counted eager; detached, the engine is chosen as
    before."""
    m = get_model("d2q9")
    lat = paint_rich(Lattice(m, (24, 48), dtype=torch.float32,
                             settings=RICH_SETTINGS, device="cpu"), 3)
    s = Sampler(m, ["Rho"], np.array([[3, 4]]), str(tmp_path / "s.csv"))
    lat.attach_sampler(s)
    assert lat.engine_name == "sampled_eager"
    lat.iterate(4)
    assert lat.eager_steps == 4 and len(s._rows) == 4
    assert [it for it, _ in s._rows] == [1, 2, 3, 4]
    s.flush()
    assert (tmp_path / "s.csv").read_text().startswith("Iteration,Rho_0\n")
    lat.detach_sampler()
    assert lat.engine_name == "eager"


@pytest.mark.parametrize("mode,target,rate", [
    ("Equal", "0.5", "0.8"),
    ("Above", "100", "0.5"),
    ("Below", "-1", "2.0"),
])
def test_keep_weight_trajectory_matches_reference(mode, target, rate,
                                                  tmp_path):
    """<Keep> on InletFlux through both packages at f64: the weight
    InletFluxInObj at every Log row (the controller's trajectory) and
    every other Log column."""
    xml = KEPT.format(out="{out}", control="", mode=mode, target=target,
                      rate=rate)
    runs = _both(xml, tmp_path)
    hp, lp = _read(runs["port"][1] / "case_Log.csv")
    hr, lr = _read(runs["ref"][1] / "case_Log.csv")
    assert hp == hr and lp.shape == lr.shape == (6, len(hp.split(",")))
    cols = hp.split(",")
    keep = [i for i, h in enumerate(cols) if "Walltime" not in h]
    np.testing.assert_allclose(lp[:, keep], lr[:, keep], rtol=RTOL,
                               atol=ATOL)
    w = lp[:, cols.index('"InletFluxInObj"')]
    assert (np.diff(w) != 0).any()


def test_keep_rejects_what_it_cannot_hold(tmp_path):
    for bad, msg in (('What="Nothing" Equal="1"', "unknown global"),
                     ('What="InletFlux"', "Above=, Below= or Equal=")):
        xml = KEPT.format(out=tmp_path, control="", mode="Equal", target=0,
                          rate=1).replace(
            'What="InletFlux" Equal="0" Rate="1"', bad)
        with pytest.raises(ValueError, match=msg):
            solver.run_config_string(xml, get_model("d2q9"),
                                     dtype=torch.float64, device="cpu")
