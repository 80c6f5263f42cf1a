"""The port's 2D adjoint models d2q9_adj, d2q9_optimalMixing and d2q9_plate
against the JAX package's, and their kernels through the plain versions.

Same inputs (made from a numpy seed) through both packages: the registry
and stage plan, the device headers' layouts, Init and the eager step at
f64 and f32, the quantities, the band engine, the backward
(``step_b_plain`` against ``jax.vjp`` of the JAX step, with two zones of
different zonal values), d2q9_plate's derivative where its stress norm
is exactly 0, d2q9_adj's unsteady gradient against the JAX package's XLA
gradient on the case of ``tests/test_pallas_adjoint.py:_setup``, and a
reduced example/adj_drag.xml through both control planes.  The kernels
run their plain versions here, on CPU tensors;
``tests/test_torch_cuda.py`` holds the kernels against them on the card.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import re  # noqa: E402
import xml.etree.ElementTree as ET  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu import adjoint as jax_adjoint  # noqa: E402
from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_action_step as jax_step  # noqa: E402
from tclb_tpu.core.lattice import make_iterate as jax_iterate  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_generic  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.adjoint import (InternalTopology,  # noqa: E402
                                    make_objective_run,
                                    make_unsteady_gradient)
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.core.lattice import make_action_step, pull_stream  # noqa: E402,E501
from tclb_tpu_torch.models.d2q9 import E, W  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (ADJ_MODELS, ADJ_SHAPE, RICH_ADJ_SETTINGS,  # noqa: E402,E501
                         RICH_ADJ_ZONE1, adj_channel, adj_planes,
                         paint_rich_adj, rich_flags_adj)

# the eager models are many small operations: one intra-op thread keeps
# several test processes from stalling each other (tests/test_torch_onestage)
torch.set_num_threads(1)

F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py:69-76
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def lattice_pair(name, prec, seed=3, shape=ADJ_SHAPE):
    """The same rich state in both packages (every node type the header
    reads, two zones with different zonal values, seeded noise)."""
    jd, td = DTYPES[prec]
    a = JaxLattice(jax_model(name), shape, dtype=jd,
                   settings=RICH_ADJ_SETTINGS[name])
    b = Lattice(get_model(name), shape, dtype=td,
                settings=RICH_ADJ_SETTINGS[name], device="cpu")
    return paint_rich_adj(a, seed), paint_rich_adj(b, seed)


# --------------------------------------------------------------------------- #
# registry, plan and device headers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_registry_matches_reference(name):
    got, want = get_model(name), jax_model(name)
    assert got.storage_names == want.storage_names
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    user = {"nu": 0.05, "PorocityTheta": -1.0, "K": 0.1}
    user = {k: v for k, v in user.items() if k in got.setting_index}
    np.testing.assert_array_equal(got.settings_vector(user),
                                  want.settings_vector(user))
    assert {n: (t.value, t.mask) for n, t in got.node_types.items()} == \
        {n: (t.value, t.mask) for n, t in want.node_types.items()}
    assert got.group_masks == want.group_masks
    assert got.groups == want.groups
    assert [(g.name, g.op) for g in got.globals_] == \
        [(g.name, g.op) for g in want.globals_]
    assert [(q.name, q.adjoint) for q in got.quantities] == \
        [(q.name, q.adjoint) for q in want.quantities]
    assert [(d.name, d.parameter) for d in got.densities] == \
        [(d.name, d.parameter) for d in want.densities]
    assert got.actions == want.actions
    assert got.fingerprint == want.fingerprint


def test_derived_settings_traps():
    """d2q9_adj's omega is the keep factor 1 - 1 / (3 nu + 0.5) (every
    other model derives 1 / (3 nu + 0.5)), and PorocityGamma comes from
    PorocityTheta: both from the registry, as the JAX package derives
    them."""
    m = get_model("d2q9_adj")
    v = m.settings_vector({"nu": 0.1, "PorocityTheta": -1.0})
    assert v[m.setting_index["omega"]] == pytest.approx(1 - 1 / 0.8)
    assert v[m.setting_index["PorocityGamma"]] == \
        pytest.approx(1 - np.exp(-1.0))
    mix = get_model("d2q9_optimalMixing")
    assert mix.settings_vector({"nu": 0.1})[mix.setting_index["omega"]] \
        == pytest.approx(1 / 0.8)


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_action_plan_matches_reference(name):
    m = get_model(name)
    want = pallas_generic.action_plan(jax_model(name))
    assert gk.action_plan(m) == want == ([("BaseIteration", 0)], 1)
    gk.check_layout(m)


def _enum(text, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_device_header_matches_registry(name):
    """csrc/models/<model>.cuh indexes the registry by position and
    carries a reverse stage."""
    dm = gk.DEVICE_MODELS[name]
    text = (_cuda_build.CSRC / dm.header).read_text()
    m = get_model(name)
    assert dm.adjoint and "#define TCLB_MODEL_ADJOINT" in text
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    for fn, col in (("ex", 0), ("ey", 1)):
        body = re.search(r"constexpr int %s\(int k\) \{\s*constexpr int t"
                         r"\[N_STORAGE\] = \{(.*?)\};" % fn, text,
                         re.S).group(1)
        np.testing.assert_array_equal(
            [int(v) for v in body.replace("\n", "").split(",")],
            m.ei[:, col])
    assert re.search(r"N_STORAGE = (\d+);", text).group(1) == \
        str(m.n_storage)


# --------------------------------------------------------------------------- #
# Init, the eager step and the quantities
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", ADJ_MODELS)
def test_init_and_steps_match_reference(name, prec):
    """Init on the painted 16x64 lattice (two zones), then seeded noise
    and three steps, against the JAX package's XLA step."""
    jd, td = DTYPES[prec]
    lats = []
    for cls, model, dt, kw in ((JaxLattice, jax_model(name), jd, {}),
                               (Lattice, get_model(name), td,
                                {"device": "cpu"})):
        lat = cls(model, ADJ_SHAPE, dtype=dt,
                  settings=RICH_ADJ_SETTINGS[name], **kw)
        lat.set_flags(rich_flags_adj(model, *ADJ_SHAPE))
        for s in model.zonal_settings:
            lat.set_setting(s, RICH_ADJ_ZONE1[s], zone=1)
        lat.init()
        lats.append(lat)
    a, b = lats
    tol = F64_TOL if prec == "f64" else F32_TOL
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               **tol)
    planes = adj_planes(b.model, ADJ_SHAPE, seed=4)
    a.set_density_planes(planes)
    b.set_density_planes(planes)
    sa, sb = a.state, b.state
    fa, fb = jax_step(a.model), make_action_step(b.model)
    for _ in range(3):
        sa, sb = fa(sa, a.params), fb(sb, b.params)
    np.testing.assert_allclose(sb.fields.numpy(), np.asarray(sa.fields),
                               **tol)
    np.testing.assert_allclose(sb.globals_.numpy(), np.asarray(sa.globals_),
                               **(tol if prec == "f64" else GLOBALS_TOL))
    assert np.count_nonzero(np.asarray(sa.globals_)) >= 3


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_quantities_match_reference(name):
    a, b = lattice_pair(name, "f64")
    for q in b.model.quantities:
        np.testing.assert_allclose(b.get_quantity(q.name).numpy(),
                                   np.asarray(a.get_quantity(q.name)),
                                   **F64_TOL)


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_band_engine_matches_reference(name):
    """Four Iterations on the band engine's plain versions (three plain
    launches and one globals launch) against the JAX package's XLA engine,
    f32."""
    a, b = lattice_pair(name, "f32")
    got = gk.make_band_iterate(b.model, ADJ_SHAPE)(b.state, b.params, 4)
    want = jax_iterate(a.model)(a.state, a.params, 4)
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **F32_TOL)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **GLOBALS_TOL)


# --------------------------------------------------------------------------- #
# the backward
# --------------------------------------------------------------------------- #


def _jax_vjp(a, lam, lam_g):
    step = jax_step(a.model)

    def fn(fields, sett):
        s = step(a.state.replace(fields=fields),
                 a.params.replace(settings=sett))
        return s.fields, s.globals_

    _, vjp = jax.vjp(fn, a.state.fields, a.params.settings)
    return vjp((jnp.asarray(lam), jnp.asarray(lam_g)))


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_step_b_plain_matches_jax_vjp(name):
    """lam_in and the settings cotangent of one Iteration against
    ``jax.vjp`` of the JAX package's step at f64, on the rich state with
    two zones of different zonal values."""
    a, b = lattice_pair(name, "f64")
    rng = np.random.default_rng(7)
    lam = rng.standard_normal((b.model.n_storage,) + ADJ_SHAPE)
    lam_g = rng.standard_normal(b.model.n_globals)
    want_in, want_s = _jax_vjp(a, lam, lam_g)
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    assert bool((ztab[:, 0] != ztab[:, 1]).all())
    ak.reset_launches()
    got_in, got_s = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                              torch.tensor(lam_g))
    assert set(ak.LAUNCHES.values()) == {0}   # plain on the CPU
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               **F64_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **F64_TOL)
    assert np.abs(np.asarray(want_s)).max() > 0


def test_plate_stress_norm_derivative_at_zero():
    """d2q9_plate's Smagorinsky rate takes sqrt(pi2); at a collision node
    whose pulled populations are exactly at rest equilibrium, pi2 == 0 and
    the JAX package's derivative is NaN (0 * inf) at the nine entries that
    node pulls from.  The port takes 0 there (the norm's subgradient that
    does not depend on the direction) and agrees with the JAX package at
    every other entry."""
    a, b = lattice_pair("d2q9_plate", "f64")
    y, x = 6, 20                    # a collision node of rich_flags_adj
    assert int(b.flags_numpy()[y, x]) & b.model.group_masks["COLLISION"]
    # pulled f_k(y, x) = f_k(y - e_k, x - e_k): 1.125 w_k, whose sum and
    # equilibrium are exact
    for lat in (a, b):
        planes = {}
        raw = np.array(lat.fields_raw())
        for k in range(9):
            plane = raw[k].copy()
            plane[y - E[k, 1], x - E[k, 0]] = 1.125 * W[k]
            planes[f"f[{k}]"] = plane
        lat.set_density_planes(planes)
    pulled = pull_stream(b.model, b.state.fields)[:9, y, x]
    assert float(pulled.sum()) == 1.125
    assert [float(v) for v in pulled] == [1.125 * float(w) for w in W]
    rng = np.random.default_rng(2)
    lam = rng.standard_normal((9,) + ADJ_SHAPE)
    lam_g = rng.standard_normal(b.model.n_globals)
    want_in, want_s = (np.asarray(v) for v in _jax_vjp(a, lam, lam_g))
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    got_in, got_s = (v.numpy() for v in ak.step_b_plain(
        f, flags, ztab, args, torch.tensor(lam), torch.tensor(lam_g)))
    bad = np.isnan(want_in)
    sources = np.zeros_like(bad)
    for k in range(9):
        sources[k, y - E[k, 1], x - E[k, 0]] = True
    np.testing.assert_array_equal(bad, sources)
    assert np.isfinite(got_in).all()
    np.testing.assert_allclose(got_in[~bad], want_in[~bad], **F64_TOL)
    np.testing.assert_allclose(got_s, want_s, **F64_TOL)


# --------------------------------------------------------------------------- #
# d2q9_adj's gradient and adj_drag.xml
# --------------------------------------------------------------------------- #


def _gradient_case(prec):
    """tests/test_pallas_adjoint.py:_setup's 16x128 channel in both
    packages and a non-uniform design theta in [0.2, 0.8]."""
    jd, td = DTYPES[prec]
    a = adj_channel(JaxLattice, jax_model("d2q9_adj"), jd)
    b = adj_channel(Lattice, get_model("d2q9_adj"), td, device="cpu")
    rng = np.random.default_rng(5)
    theta = 0.2 + 0.6 * rng.random((1,) + b.shape)
    return a, b, theta


def test_unsteady_gradient_matches_reference():
    """Eight steps with two checkpoint levels at f64 (the levels' loop is
    the model-independent one tests/test_torch_heat_adj.py holds)."""
    levels = 2
    a, b, theta = _gradient_case("f64")
    ref = jax_adjoint.make_unsteady_gradient(
        a.model, jax_adjoint.InternalTopology(a.model), 8, levels=levels,
        engine="xla")
    obj_r, g_r, fin_r = ref(jnp.asarray(theta), a.state, a.params)
    port = make_unsteady_gradient(b.model, InternalTopology(b.model), 8,
                                  levels=levels, shape=b.shape,
                                  dtype=torch.float64, device="cpu")
    assert port.engine_name == "eager"
    obj_p, g_p, fin_p = port(torch.tensor(theta), b.state, b.params)
    g_r = np.asarray(g_r)
    assert np.abs(g_r).max() > 0
    assert float(obj_p) == pytest.approx(float(obj_r), rel=1e-10)
    np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fin_p.fields.numpy(),
                               np.asarray(fin_r.fields), **F64_TOL)


def test_kernel_step_matches_eager():
    """The kernel step (its plain versions on CPU tensors): forward
    ``generic2d_step``'s globals flavour, backward ``generic2d_step_b``,
    through ``make_objective_run``, against the eager step's autograd,
    f32."""
    _, b, theta = _gradient_case("f32")
    m = b.model
    step = ak.make_diff_step(m, b.shape)
    assert step.engine_name == "cuda_adjoint[d2q9_adj,k=1]"
    design = InternalTopology(m)
    p = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    st, pa = design.put(p, b.state, b.params)
    obj, fin = make_objective_run(m, 8, levels=1, step=step)(st, pa)
    got, = torch.autograd.grad(obj, p)
    eager = make_unsteady_gradient(m, design, 8, levels=1, engine="eager",
                                   device="cpu")
    obj_e, want, fin_e = eager(torch.tensor(theta, dtype=torch.float32),
                               b.state, b.params)
    assert float(obj.detach()) == pytest.approx(float(obj_e), rel=1e-6)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(fin.fields.detach(), fin_e.fields,
                               **F32_TOL)


# example/adj_drag.xml reduced: 32x16 with the design block scaled, FDTest
# 4/2, MMA with 2 evaluations of 8 iterations, ThresholdNow, Solve 20
ADJ_DRAG_SMALL = """<?xml version="1.0"?>
<CLBConfig version="2.0" model="d2q9_adj" output="{out}/">
    <Geometry nx="32" ny="16">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Inlet/></WVelocity>
        <EPressure name="Outlet"><Outlet/></EPressure>
        <Wall mask="ALL"><Channel/></Wall>
        <DesignSpace><Box dx="10" nx="12" dy="4" ny="8"/></DesignSpace>
    </Geometry>
    <Model>
        <Params Velocity="0.05" nu="0.1" Porocity="0.5"
                DragInObj="1.0" MaterialInObj="0.01"/>
    </Model>
    <FDTest Iterations="4" Checks="2"/>
    <Optimize Method="MMA" MaxEvaluations="2" Iterations="8"
              Material="less">
        <InternalTopology/>
    </Optimize>
    <ThresholdNow/>
    <Solve Iterations="20"/>
</CLBConfig>
"""


def test_adj_drag_xml_matches_reference(tmp_path):
    """The reduced adj_drag.xml through both control planes at f64: the
    same objectives, FD probes, final design (binary after ThresholdNow)
    and fields after the last Solve, and a material constraint that
    holds."""
    runs = []
    for run_root, model, dtype, tag in (
            (solver._run_root, get_model("d2q9_adj"), torch.float64,
             "port"),
            (jax_solver._run_root, jax_model("d2q9_adj"), jnp.float64,
             "ref")):
        out = tmp_path / tag
        kw = {"device": "cpu"} if tag == "port" else {}
        xml = ADJ_DRAG_SMALL.format(out=out)
        runs.append(run_root(ET.fromstring(xml), model, None, dtype,
                             str(out) + "/", "d", **kw))
    port, ref = runs
    assert port.adjoint_engine == "eager"
    assert port.objective == pytest.approx(ref.objective, rel=1e-8)
    assert len(port.opt_history) == 2
    assert [r["index"] for r in port.fd_records] == \
        [r["index"] for r in ref.fd_records]
    for got, want in zip(port.fd_records, ref.fd_records):
        assert got["adjoint"] == pytest.approx(want["adjoint"], rel=1e-8,
                                               abs=1e-12)
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               rtol=1e-8, atol=1e-10)
    assert port.iter == ref.iter
    mat = port.opt_material
    assert mat["direction"] == "less"
    assert mat["end"] <= mat["start"] * (1 + 1e-6)
    design = (port.lattice.flags_numpy()
              & port.model.group_masks["DESIGNSPACE"]) != 0
    w = port.lattice.state.fields.numpy()[9][design]
    assert set(np.unique(w)) == {0.0, 1.0}


# --------------------------------------------------------------------------- #
# engines and bounds
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ADJ_MODELS)
def test_engine_choice(name):
    m = get_model(name)
    assert gk.select_engine(m, (32, 64), torch.float32)[1] == \
        f"cuda_generic_resident[{name},fuse=N]"
    assert gk.select_engine(m, (512, 1024), torch.float32)[1] == \
        f"cuda_generic_band[{name},fuse=1]"
    assert gk.select_engine(m, (32, 64), torch.float64) == (None, None)
    assert ak.supports_diff(m, (512, 1024), torch.float32)
    # adj_drag.xml's 64x32: the reference's rejects it (nx % 128)
    assert ak.supports_diff(m, (32, 64), torch.float32)
    assert not ak.supports_diff(m, (32, 64), torch.float64)
    assert not ak.supports_diff(m, (32, 64), torch.float32,
                                storage_dtype=torch.bfloat16)


@pytest.mark.parametrize("name,fwd,bwd", [("d2q9_adj", 84, 124),
                                          ("d2q9_optimalMixing", 116, 172),
                                          ("d2q9_plate", 76, 112)])
def test_bound_counts(name, fwd, bwd):
    """K4 moves each plane read and written and the int32 flags (and the
    zone table once); K7 reads the primal, lam_out and the flags and writes
    lam_in."""
    m = get_model(name)
    table = 4 * len(m.zonal_settings) * m.zone_max
    assert gk.launch_bytes(m, (1024, 1024)) == fwd * 1024 * 1024 + table
    assert ak.launch_bytes_b(m, (512, 1024)) == bwd * 512 * 1024
    flags = rich_flags_adj(m, *ADJ_SHAPE)
    assert 0 < gk.node_step_flops(m, flags) < ak.node_step_b_flops(m, flags)
