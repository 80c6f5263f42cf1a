"""The port's adjoint package against the JAX package's: designs, the
steady gradient, the finite-difference check, the optimizers and the
optimization handlers, at f64 on the CPU with inputs made from a numpy
seed.  (The unsteady gradient and the kernels' plain versions are in
``tests/test_torch_heat_adj.py``.)"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import importlib  # noqa: E402
import warnings  # noqa: E402
import xml.etree.ElementTree as ET  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu import adjoint as jax_adjoint  # noqa: E402
from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch import adjoint  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from torch_cases import HEAT_SETTINGS, paint_rich_heat  # noqa: E402

# the modules (each package's adjoint namespace exports its optimize())
opt = importlib.import_module("tclb_tpu_torch.adjoint.optimize")
jax_opt = importlib.import_module("tclb_tpu.adjoint.optimize")
NAME = "d2q9_heat_adj"
SHAPE = (16, 32)


def lattice_pair(seed=3, shape=SHAPE):
    a = JaxLattice(jax_model(NAME), shape, dtype=jnp.float64,
                   settings=HEAT_SETTINGS)
    b = Lattice(get_model(NAME), shape, dtype=torch.float64,
                settings=HEAT_SETTINGS, device="cpu")
    return paint_rich_heat(a, seed), paint_rich_heat(b, seed)


# --------------------------------------------------------------------------- #
# designs
# --------------------------------------------------------------------------- #


def test_internal_topology_and_threshold_match_reference():
    a, b = lattice_pair()
    da, db = jax_adjoint.InternalTopology(a.model), \
        adjoint.InternalTopology(b.model)
    ta, tb = da.get(a.state, a.params), db.get(b.state, b.params)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(ta))
    assert db.bounds() == da.bounds() == (0.0, 1.0)
    rng = np.random.default_rng(2)
    theta = rng.random(tuple(tb.shape))
    sa, _ = da.put(jnp.asarray(theta), a.state, a.params)
    sb, _ = db.put(torch.tensor(theta), b.state, b.params)
    np.testing.assert_array_equal(sb.fields.numpy(), np.asarray(sa.fields))
    for level in (0.5, 0.3):
        np.testing.assert_array_equal(
            adjoint.threshold_topology(b.model, sb, level).fields.numpy(),
            np.asarray(jax_adjoint.threshold_topology(a.model, sa,
                                                      level).fields))
    both = adjoint.CompositeDesign([db, db])
    assert len(both.get(b.state, b.params)) == 2
    assert both.bounds() == ((0.0, 1.0), (0.0, 1.0))


@pytest.mark.parametrize("cls", ["OptimalControl", "Fourier", "BSpline",
                                 "RepeatControl", "ControlSecond"])
def test_series_designs_name_their_roadmap_item(cls):
    with pytest.raises(NotImplementedError, match="item 10"):
        getattr(adjoint, cls)(get_model(NAME), "InletVelocity")


# --------------------------------------------------------------------------- #
# the steady gradient and the finite-difference check
# --------------------------------------------------------------------------- #


def test_steady_gradient_matches_reference():
    """The Neumann series of one step's VJPs at f64: the same objective
    and gradient after the same number of passes."""
    a, b = lattice_pair(4)
    da, db = jax_adjoint.InternalTopology(a.model), \
        adjoint.InternalTopology(b.model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        obj_a, g_a = jax_adjoint.make_steady_gradient(
            a.model, da, n_adjoint=12, engine="xla")(
            da.get(a.state, a.params), a.state, a.params)
        fn = adjoint.make_steady_gradient(b.model, db, n_adjoint=12,
                                          shape=b.shape,
                                          dtype=torch.float64,
                                          device="cpu")
        obj_b, g_b = fn(db.get(b.state, b.params), b.state, b.params)
    assert fn.engine_name == "eager"
    assert float(obj_b) == pytest.approx(float(obj_a), rel=1e-10)
    g_a = np.asarray(g_a)
    assert np.abs(g_a).max() > 0
    np.testing.assert_allclose(g_b.numpy(), g_a, rtol=1e-9, atol=1e-12)


def test_fd_test_agrees_with_the_adjoint():
    """Central differences of the eager objective at f64 against the
    unsteady gradient, on design nodes (rel 1e-5), and the same probes
    as the JAX package's fd_test."""
    _, b = lattice_pair(5)
    m = b.model
    design = adjoint.InternalTopology(m)
    theta = design.get(b.state, b.params)
    obj, g, _ = adjoint.make_unsteady_gradient(
        m, design, 6, levels=1, shape=b.shape, dtype=torch.float64,
        device="cpu")(theta, b.state, b.params)
    run = adjoint.make_objective_run(m, 6)

    def loss(th):
        st, pa = design.put(th, b.state, b.params)
        return run(st, pa)[0]

    assert float(loss(theta)) == pytest.approx(float(obj), rel=1e-12)
    records = adjoint.fd_test(loss, g, theta, n_checks=16, eps=1e-6)
    ref = jax_adjoint.fd_test(lambda th: 0.0, jnp.asarray(g.numpy()),
                              jnp.asarray(theta.numpy()), n_checks=16)
    assert [r["index"] for r in records] == [r["index"] for r in ref]
    probed = [r for r in records if r["adjoint"] != 0.0]
    assert probed, "vacuous: no probe on a design node"
    for r in probed:
        assert r["rel_err"] < 1e-5, r


# --------------------------------------------------------------------------- #
# the optimizers
# --------------------------------------------------------------------------- #

TARGET = np.array([0.9, 0.1, 0.7, 0.3, 0.95, 0.6, 0.2, 0.8])
MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1], dtype=np.float64)


def _problem(xp):
    """A separable smooth objective on [0, 1]^8 whose unconstrained
    minimum uses more material than the 'less' constraint allows."""
    def grad_fn(theta):
        d = theta - xp.asarray(TARGET)
        obj = (d * d).sum() + 0.3 * (theta ** 3).sum()
        return obj, 2 * d + 0.9 * theta ** 2
    return grad_fn


def _run(pkg, xp, method, material, **kw):
    trace = []
    theta0 = xp.asarray(np.full(8, 0.5))
    theta, obj = pkg.optimize(
        _problem(xp), theta0, method=method, max_eval=12, bounds=(0.0, 1.0),
        material=material,
        callback=lambda k, o, th: trace.append((o, np.asarray(th))), **kw)
    return np.asarray(theta), float(obj), trace


@pytest.mark.parametrize("method,material", [
    ("MMA", ("less", 3.0, MASK)), ("MMA", None),
    ("DESCENT", ("less", 3.0, MASK)), ("ADAM", ("more", 4.5, MASK)),
    ("LBFGS", None), ("LBFGS", ("less", 3.0, MASK))])
def test_optimizer_iterates_match_reference(method, material):
    """Every evaluation's objective and design, and the result, against
    the JAX package's optimizer at f64 (ADAM against optax.adam)."""
    kw = {"step": 0.05} if method in ("DESCENT", "ADAM") else {}
    got = _run(opt, torch, method, material, **kw)
    want = _run(jax_opt, jnp, method, material, **kw)
    assert len(got[2]) == len(want[2]) > 1
    for (og, tg), (ow, tw) in zip(got[2], want[2]):
        assert og == pytest.approx(ow, rel=1e-10, abs=1e-12)
        np.testing.assert_allclose(tg, tw, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-10)
    if material is not None and method == "MMA":
        assert got[0] @ MASK <= 3.0 + 1e-9


def test_batched_descent_matches_reference():
    def batch(xp):
        fn = _problem(xp)
        return lambda thetas: [fn(t) for t in thetas]

    got = opt.batched_descent(batch(torch), torch.full((8,), 0.5,
                                                        dtype=torch.float64),
                              max_iter=6, bounds=(0.0, 1.0))
    want = jax_opt.batched_descent(batch(jnp), jnp.full((8,), 0.5),
                                   max_iter=6, bounds=(0.0, 1.0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-12)


# --------------------------------------------------------------------------- #
# the handlers
# --------------------------------------------------------------------------- #

# example/heat_adj.xml reduced: 32x16, Solve 50, FDTest 4/2, MMA with 2
# evaluations of 8 iterations, ThresholdNow
HEAT_ADJ_SMALL = """<?xml version="1.0"?>
<CLBConfig version="2.0" model="d2q9_heat_adj" output="{out}/">
    <Geometry nx="32" ny="16">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Box nx="1"/></WVelocity>
        <EPressure name="Outlet"><Box dx="-1"/></EPressure>
        <Wall mask="ALL"><Channel/></Wall>
        <Outlet nx="1" dx="-2"><Box/></Outlet>
        <DesignSpace><Box dx="8" nx="16"/></DesignSpace>
    </Geometry>
    <Model>
        <Params InletVelocity="0.02" nu="0.05"/>
        <Params InletTemperature="1" InitTemperature="0"/>
        <Params FluidAlfa="0.05" SolidAlfa="0.005"/>
        <Params HeatFluxInObj="1.0" DragInObj="0.1"/>
    </Model>
    <Solve Iterations="50"/>
    <FDTest Iterations="4" Checks="2"/>
    <Optimize Method="MMA" MaxEvaluations="2" Iterations="8"
              Material="less">
        <InternalTopology/>
    </Optimize>
    {after}
</CLBConfig>
"""


@pytest.mark.parametrize("after", ["<ThresholdNow/>", ""])
def test_heat_adj_xml_matches_reference(tmp_path, after):
    """The reduced heat_adj.xml through both control planes at f64: the
    same objectives, FD probes and final design (binary after
    ThresholdNow), and a material constraint that holds."""
    runs = []
    for run_root, model, dtype, tag in (
            (solver._run_root, get_model(NAME), torch.float64, "port"),
            (jax_solver._run_root, jax_model(NAME), jnp.float64, "ref")):
        out = tmp_path / tag
        kw = {"device": "cpu"} if tag == "port" else {}
        xml = HEAT_ADJ_SMALL.format(out=out, after=after)
        runs.append(run_root(ET.fromstring(xml), model, None, dtype,
                             str(out) + "/", "h", **kw))
    port, ref = runs
    assert port.adjoint_engine == "eager"
    assert port.objective == pytest.approx(ref.objective, rel=1e-8)
    assert [r["index"] for r in port.fd_records] == \
        [r["index"] for r in ref.fd_records]
    w_port = port.lattice.state.fields.numpy()[18]
    w_ref = np.asarray(ref.lattice.state.fields)[18]
    np.testing.assert_allclose(w_port, w_ref, rtol=1e-8, atol=1e-8)
    assert len(port.opt_history) == 2
    mat = port.opt_material
    assert mat["direction"] == "less"
    assert mat["end"] <= mat["start"] * (1 + 1e-6)
    if after:
        assert set(np.unique(w_port)) <= {0.0, 1.0}


def test_adjoint_handler_unsteady_and_steady(tmp_path):
    """<Adjoint> records the engine, objective and gradient; an unsteady
    one advances the primal."""
    xml = HEAT_ADJ_SMALL.format(out=tmp_path, after="").replace(
        """    <FDTest Iterations="4" Checks="2"/>
    <Optimize Method="MMA" MaxEvaluations="2" Iterations="8"
              Material="less">
        <InternalTopology/>
    </Optimize>""", """<Adjoint Iterations="6"><InternalTopology/></Adjoint>
    <Adjoint type="steady" NAdjoint="3"/>""")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s = solver.run_config_string(xml, get_model(NAME),
                                     dtype=torch.float64, device="cpu")
    assert s.iter == 56 and s.adjoint_engine == "eager"
    assert np.isfinite(s.objective)
    assert tuple(s.gradient.shape) == (1, 16, 32)
