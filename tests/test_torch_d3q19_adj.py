"""The port's d3q19 and d3q19_adj against the JAX package's, and the 3D
adjoint slice's kernels through their plain versions.

Same inputs (made from a numpy seed) through both packages: the lbm
pieces, the registry, the eager step at f64 and f32 on an 8x16x32 state
that paints every node type d3q19_adj reads, the generic 3D engine
(``generic3d_step``'s plain versions) against the JAX package's XLA
engine, the backward (``step_b_plain`` against ``jax.vjp`` of the JAX
step), the unsteady gradient against the JAX package's XLA gradient on
``tests/test_pallas_adjoint.py::_setup_3d``'s case cut to (4, 8, 16) and 4
steps, and the 3D adjoint case XML (``torch_cases.adj3d_case_xml``) at its
test size.  The kernel wrappers run their plain versions here, on CPU
tensors; ``tests/test_torch_cuda.py`` holds the kernels against them on
the card.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
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
from tclb_tpu.ops import lbm as jax_lbm  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.adjoint import (InternalTopology, auto_levels,  # noqa: E402,E501
                                    fd_test, make_objective_run,
                                    make_unsteady_gradient)
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy  # noqa: E402
from tclb_tpu_torch.core.lattice import make_action_step  # noqa: E402
from tclb_tpu_torch.models import d3q19  # noqa: E402
from tclb_tpu_torch.models.family import mirror_perm  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build, lbm  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic3d_kernels as g3  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (ADJ3D_SETTINGS, ADJ3D_SHAPE,  # noqa: E402
                         adj3d_case_xml, adj3d_design_block,
                         bench_adjoint3d_lattice, paint_rich_adj3d,
                         rich_flags_adj3d)

NAME = "d3q19_adj"
F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py:69-76
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def settings_for(name):
    m = get_model(name)
    return {k: v for k, v in ADJ3D_SETTINGS.items() if k in m.setting_index}


def lattice_pair(name, prec, seed=3, shape=ADJ3D_SHAPE):
    """The same painted state in both packages."""
    jd, td = DTYPES[prec]
    a = JaxLattice(jax_model(name), shape, dtype=jd,
                   settings=settings_for(name))
    b = Lattice(get_model(name), shape, dtype=td,
                settings=settings_for(name), device="cpu")
    return paint_rich_adj3d(a, seed), paint_rich_adj3d(b, seed)


# --------------------------------------------------------------------------- #
# the lbm pieces and the registry
# --------------------------------------------------------------------------- #


def test_lbm_pieces_match_reference():
    """d3q19_velocities and gram_schmidt_basis are exact copies; the
    two-rate relaxation agrees at f64 on random inputs."""
    E = lbm.d3q19_velocities()
    np.testing.assert_array_equal(E, jax_lbm.d3q19_velocities())
    for e in (E, np.asarray(get_model("d2q9").ei[:9, :2])):
        np.testing.assert_array_equal(lbm.gram_schmidt_basis(e),
                                      jax_lbm.gram_schmidt_basis(e))
    M = lbm.gram_schmidt_basis(E)
    rng = np.random.default_rng(0)
    fneq = rng.standard_normal((19, 5, 7))
    ks, kh = 0.3, -0.2
    got = lbm.two_rate_relax(M, 4, 10, list(torch.tensor(fneq)),
                             torch.tensor(ks, dtype=torch.float64),
                             torch.tensor(kh, dtype=torch.float64))
    want = jax_lbm.two_rate_relax(M, 4, 10, list(jnp.asarray(fneq)),
                                  jnp.float64(ks), jnp.float64(kh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    # the identity it rests on: the stress rows keep ks, the higher kh
    Minv = lbm.inverse_basis(M)
    fneq_c = fneq - np.einsum("ij,j...->i...", Minv[:, :4],
                              np.einsum("ij,j...->i...", M[:4], fneq))
    keep = np.array([0.0] * 4 + [ks] * 6 + [kh] * 9)
    full = np.einsum("ij,j...->i...", Minv * keep[None],
                     np.einsum("ij,j...->i...", M, fneq_c))
    got_c = lbm.two_rate_relax(M, 4, 10, list(torch.tensor(fneq_c)),
                               torch.tensor(ks, dtype=torch.float64),
                               torch.tensor(kh, dtype=torch.float64))
    np.testing.assert_allclose(got_c.numpy(), full, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["d3q19", NAME])
def test_registry_matches_reference(name):
    got, want = get_model(name), jax_model(name)
    assert got.storage_names == want.storage_names
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    assert got.zonal_settings == want.zonal_settings
    np.testing.assert_array_equal(got.settings_vector(settings_for(name)),
                                  want.settings_vector(settings_for(name)))
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
    np.testing.assert_array_equal(got.ei, want.ei)
    assert got.actions == want.actions
    assert got.structural_key() == want.structural_key()
    assert got.fingerprint == want.fingerprint
    for names in (("MRT",), ("WVelocity", "MRT"), ("Wall",),
                  ("MRT", "DesignSpace", "Outlet")):
        assert got.flag_for(*names, zone=2) == want.flag_for(*names, zone=2)


# --------------------------------------------------------------------------- #
# the eager step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", ["d3q19", NAME])
def test_eager_step_matches_reference(name, prec):
    """One step on the rich 8x16x32 state: every node type, two zones, a
    design field in (0.1, 0.9); f64 at rtol 1e-10, f32 at the engines'
    tolerance (globals rtol 1e-4 / atol 1e-6)."""
    a, b = lattice_pair(name, prec)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.state.fields, np.float64))
    flags = b.flags_numpy()
    for t in ("WVelocity", "WPressure", "EVelocity", "EPressure",
              "NSymmetry", "SSymmetry", "Wall", "Solid", "BGK", "MRT",
              "Inlet", "Outlet", "DesignSpace"):
        assert gk.count_types(b.model, flags, t), t
    want = jax_step(a.model)(a.state, a.params)
    got = make_action_step(b.model)(b.state, b.params)
    tol = F64_TOL if prec == "f64" else F32_TOL
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **tol)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_),
                               **(tol if prec == "f64" else GLOBALS_TOL))
    assert np.all(np.asarray(want.globals_) != 0)


def test_quantities_match_reference():
    a, b = lattice_pair(NAME, "f64")
    for q in ("Rho", "U", "W", "WB"):
        np.testing.assert_allclose(b.get_quantity(q).numpy(),
                                   np.asarray(a.get_quantity(q)), **F64_TOL)


def test_state_converts_from_reference():
    """convert.state_from_numpy carries the JAX package's d3q19_adj state
    and params over unchanged."""
    a, b = lattice_pair(NAME, "f64")
    st, pa = state_from_numpy(
        b.model, np.asarray(a.state.fields), np.asarray(a.state.flags),
        np.asarray(a.state.globals_), a.state.iteration,
        np.asarray(a.params.settings), np.asarray(a.params.zone_table),
        device="cpu")
    assert torch.equal(st.fields, b.state.fields)
    assert torch.equal(st.flags, b.state.flags)
    assert torch.equal(pa.settings, b.params.settings)
    assert torch.equal(pa.zone_table, b.params.zone_table)


# --------------------------------------------------------------------------- #
# the generic 3D engine (plain versions)
# --------------------------------------------------------------------------- #


def test_plain_engine_matches_reference():
    """Five Iterations on the band engine (four plain launches and one
    globals launch) against the JAX package's XLA engine, f32."""
    a, b = lattice_pair(NAME, "f32")
    g3.reset_launches()
    got = g3.make_band_iterate(b.model, ADJ3D_SHAPE)(b.state, b.params, 5)
    assert g3.LAUNCHES == {"generic3d_step": 0}      # plain on the CPU
    want = jax_iterate(a.model)(a.state, a.params, 5)
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **F32_TOL)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **GLOBALS_TOL)
    assert got.iteration == b.state.iteration + 5


@pytest.mark.parametrize("with_globals", [False, True])
def test_plain_step_matches_reference_step(with_globals):
    """The kernel wrappers' plain versions on the kernels' inputs against
    the JAX package's action step, fields and globals, f32."""
    a, b = lattice_pair(NAME, "f32", seed=4)
    f, flags, ztab, args = g3.kernel_inputs(b.model, b.state, b.params)
    assert args.shape == ADJ3D_SHAPE and args.nz == ADJ3D_SHAPE[0]
    assert tuple(ztab.shape) == (3, b.model.zone_max)
    want = jax_step(a.model)(a.state, a.params)
    if with_globals:
        got, g = g3.step_globals(f, flags, ztab, args)
        np.testing.assert_allclose(g.numpy(), np.asarray(want.globals_),
                                   **GLOBALS_TOL)
    else:
        got = g3.step(f, flags, ztab, args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.fields),
                               **F32_TOL)


def test_engine_choice():
    m = get_model(NAME)
    assert g3.select_engine(m, (32, 64, 256), torch.float32)[1] == \
        "cuda_generic3d_band[d3q19_adj,fuse=1]"
    assert g3.supports(m, (5, 7, 9), torch.float32)   # no alignment
    assert g3.select_engine(m, (32, 64, 256), torch.float64) == (None, None)
    # d3q19 has no device header; the 2D engines take no 3D model
    assert g3.select_engine(get_model("d3q19"), (8, 8, 8),
                            torch.float32) == (None, None)
    assert gk.select_engine(m, (32, 64, 256), torch.float32) == (None, None)
    assert not g3.supports(get_model("d2q9_heat_adj"), (32, 64),
                           torch.float32)
    assert ak.supports_diff(m, (32, 64, 256), torch.float32)
    assert not ak.supports_diff(m, (32, 64, 256), torch.float64)
    step = ak.make_diff_step(m, (4, 8, 16))
    assert step.engine_name == "cuda_adjoint3d[d3q19_adj,k=1]"
    assert step.chunk == 1 and step.returns_inc
    with pytest.raises(ValueError, match="3D model"):
        gk.lib(NAME)


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


@pytest.mark.parametrize("seed", [0, 1])
def test_step_b_plain_matches_jax_vjp(seed):
    """lam_in and the settings cotangent of one Iteration against
    ``jax.vjp`` of the JAX package's step at f64 (rtol 1e-10); the
    zonal settings (Velocity, Density, Porocity) get none."""
    a, b = lattice_pair(NAME, "f64")
    rng = np.random.default_rng(seed)
    lam = rng.standard_normal((b.model.n_storage,) + ADJ3D_SHAPE)
    lam_g = rng.standard_normal(b.model.n_globals)
    want_in, want_s = _jax_vjp(a, lam, lam_g)
    f, flags, ztab, args = g3.kernel_inputs(b.model, b.state, b.params)
    ak.reset_launches()
    got_in, got_s = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                              torch.tensor(lam_g))
    assert ak.LAUNCHES == {"generic2d_step_b": 0, "generic3d_step_b": 0}
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               **F64_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **F64_TOL)
    assert got_s.dtype == torch.float64
    si = b.model.setting_index
    for name in ("omega", "S_high", "PorocityGamma", "GravitationX",
                 "GravitationY", "GravitationZ"):
        assert float(got_s[si[name]]) != 0.0, name
    for name in b.model.zonal_settings:
        assert float(got_s[si[name]]) == 0.0, name


# --------------------------------------------------------------------------- #
# the gradient
# --------------------------------------------------------------------------- #


def _gradient_case(prec, shape=(4, 8, 16)):
    """tests/test_pallas_adjoint.py::_setup_3d's case cut to (4, 8, 16):
    walls on y, periodic x and z, a DesignSpace block, Drag as the
    objective, theta = 0.3 + 0.5 w on the block."""
    out = []
    for lat_cls, model, dt, kw in (
            (JaxLattice, jax_model(NAME), DTYPES[prec][0], {}),
            (Lattice, get_model(NAME), DTYPES[prec][1], {"device": "cpu"})):
        lat = lat_cls(model, shape, dtype=dt,
                      settings={"nu": 0.1, "Velocity": 0.02,
                                "Porocity": 0.5, "DragInObj": 1.0}, **kw)
        flags = np.full(shape, model.flag_for("MRT"), np.uint16)
        flags[:, 0, :] = flags[:, -1, :] = model.flag_for("Wall")
        flags[1:3, 2:6, 4:11] |= np.uint16(model.flag_for("DesignSpace"))
        lat.set_flags(flags)
        lat.init()
        out.append(lat)
    a, b = out
    rng = np.random.default_rng(7)
    theta = 0.3 + 0.5 * rng.random((1,) + shape)
    return a, b, theta


@pytest.mark.parametrize("engine", ["eager", "kernel"])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_unsteady_gradient_matches_reference(prec, engine):
    """The 4-step unsteady gradient (levels 1) of the port's eager engine
    and of its kernel step (``make_diff_step``; its plain versions, which
    take the dtype they are given, on CPU tensors) against the JAX
    package's XLA gradient: f64 at rtol 1e-9 / atol 1e-12, f32 at rtol
    1e-4 / atol 1e-7 (tests/test_pallas_adjoint.py:155)."""
    a, b, theta = _gradient_case(prec)
    jd, td = DTYPES[prec]
    ref = jax_adjoint.make_unsteady_gradient(
        a.model, jax_adjoint.InternalTopology(a.model), 4, levels=1,
        engine="xla")
    obj_r, g_r, fin_r = ref(jnp.asarray(theta, jd), a.state, a.params)
    design = InternalTopology(b.model)
    p = torch.tensor(theta, dtype=td)
    if engine == "eager":
        port = make_unsteady_gradient(b.model, design, 4, levels=1,
                                      shape=b.shape, dtype=td, device="cpu")
        assert port.engine_name == "eager"
        obj_p, g_p, fin_p = port(p, b.state, b.params)
    else:
        step = ak.make_diff_step(b.model, b.shape)
        p.requires_grad_()
        st, pa = design.put(p, b.state, b.params)
        obj_p, fin_p = make_objective_run(b.model, 4, levels=1,
                                          step=step)(st, pa)
        g_p, = torch.autograd.grad(obj_p, p)
    g_r = np.asarray(g_r)
    assert np.abs(g_r).max() > 0 and float(obj_r) != 0
    if prec == "f64":
        assert float(obj_p.detach()) == pytest.approx(float(obj_r),
                                                      rel=1e-10)
        np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-9, atol=1e-12)
    else:
        assert float(obj_p.detach()) == pytest.approx(float(obj_r),
                                                      rel=1e-5)
        np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(fin_p.fields.detach().numpy(),
                               np.asarray(fin_r.fields),
                               **(F64_TOL if prec == "f64" else F32_TOL))


@pytest.mark.parametrize("levels", [1, 2])
def test_kernel_step_matches_eager(levels):
    """The kernel step through ``make_objective_run``'s
    ``returns_inc``/``prepare`` protocol and the checkpointed loop,
    against the eager step's autograd, f32, 8 steps."""
    _, b, theta = _gradient_case("f32")
    m = b.model
    design = InternalTopology(m)
    p = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    st, pa = design.put(p, b.state, b.params)
    obj, fin = make_objective_run(m, 8, levels=levels,
                                  step=ak.make_diff_step(m, b.shape))(st, pa)
    got, = torch.autograd.grad(obj, p)
    eager = make_unsteady_gradient(m, design, 8, levels=levels,
                                   engine="eager", device="cpu")
    obj_e, want, fin_e = eager(torch.tensor(theta, dtype=torch.float32),
                               b.state, b.params)
    assert float(obj.detach()) == pytest.approx(float(obj_e), rel=1e-6)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(fin.fields.detach(), fin_e.fields,
                               **F32_TOL)


def test_fd_on_design_components():
    """Central differences at three components inside the design block
    agree with the f64 adjoint to 1e-6 (components outside it have
    gradient 0 and FD 0)."""
    _, b, theta = _gradient_case("f64")
    m = b.model
    design = InternalTopology(m)
    grad_fn = make_unsteady_gradient(m, design, 4, levels=1,
                                     dtype=torch.float64, device="cpu")
    th = torch.tensor(theta)
    _, g, _ = grad_fn(th, b.state, b.params)
    run = make_objective_run(m, 4)

    def loss(t):
        st, pa = design.put(t, b.state, b.params)
        return run(st, pa)[0]

    idx = [int(np.ravel_multi_index((0, z, y, x), th.shape))
           for z, y, x in ((1, 2, 4), (2, 4, 7), (1, 5, 10))]
    records = fd_test(loss, g, th, indices=idx, eps=1e-6)
    assert [r["index"] for r in records] == idx
    for r in records:
        assert r["adjoint"] != 0 and r["rel_err"] < 1e-6, r


def test_auto_levels():
    m = get_model(NAME)
    # 20 f32 planes of 32x64x256 are 41.9 MB: 200 of them exceed 6e9
    assert auto_levels(m, (32, 64, 256), 200) == 2
    assert auto_levels(m, (32, 64, 256), 100) == 1
    # 64x128x256: 167.8 MB a state
    assert auto_levels(m, (64, 128, 256), 1000) == 2


def test_bench_adjoint3d_case_paints_alike():
    """bench.py:bench_adjoint3d's lattice, built in both packages at a
    small size: the same flags and initial state."""
    shape = (8, 16, 32)
    a = bench_adjoint3d_lattice(JaxLattice, jax_model(NAME), jnp.float64,
                                shape)
    b = bench_adjoint3d_lattice(Lattice, get_model(NAME), torch.float64,
                                shape, device="cpu")
    np.testing.assert_array_equal(b.flags_numpy(), np.asarray(a.state.flags))
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               **F64_TOL)


# --------------------------------------------------------------------------- #
# the case XML
# --------------------------------------------------------------------------- #

_HANDLERS = ("Solve", "FDTest", "Optimize", "ThresholdNow", "VTK")


def test_case_xml_paints_like_reference(tmp_path):
    """The case XML's geometry and settings at its test size: the port's
    painter gives the JAX painter's flags, zone table and initial state."""
    lats = []
    for run_root, model, dtype, tag in (
            (solver._run_root, get_model(NAME), torch.float64, "port"),
            (jax_solver._run_root, jax_model(NAME), jnp.float64, "ref")):
        root = ET.fromstring(adj3d_case_xml("test", str(tmp_path / tag)
                                            + "/"))
        for el in [el for el in root if el.tag in _HANDLERS]:
            root.remove(el)
        kw = {"device": "cpu"} if tag == "port" else {}
        lats.append(run_root(root, model, None, dtype,
                             str(tmp_path / tag) + "/", "c", **kw).lattice)
    port, ref = lats
    flags = port.flags_numpy()
    np.testing.assert_array_equal(flags, np.asarray(ref.state.flags))
    m = port.model
    assert gk.count_types(m, flags, "WVelocity") \
        and gk.count_types(m, flags, "EPressure") \
        and gk.count_types(m, flags, "Wall")
    design = (flags & m.group_masks["DESIGNSPACE"]) != 0
    want = np.zeros(port.shape, bool)
    want[adj3d_design_block(port.shape)] = True
    np.testing.assert_array_equal(design, want)
    np.testing.assert_allclose(port.fields_raw(),
                               np.asarray(ref.state.fields), **F64_TOL)
    np.testing.assert_allclose(port.params.zone_table.numpy(),
                               np.asarray(ref.params.zone_table), **F64_TOL)


def test_case_xml_runs_every_handler(tmp_path):
    """The case XML at its test size through the port's control plane on
    the CPU (f32, eager): Solve, FDTest, the MMA Optimize under its
    material constraint, ThresholdNow and VTK, with finite objectives."""
    out = str(tmp_path) + "/"
    s = solver._run_root(ET.fromstring(adj3d_case_xml("test", out)),
                         get_model(NAME), None, torch.float32, out, "case",
                         device="cpu")
    assert s.adjoint_engine == "eager"
    assert s.iter == 50
    assert len(s.fd_records) == 2
    assert all(math.isfinite(r["adjoint"]) and math.isfinite(r["fd"])
               for r in s.fd_records)
    assert len(s.opt_history) == 2
    assert all(math.isfinite(o) for o in s.opt_history)
    mat = s.opt_material
    assert mat["direction"] == "less"
    assert mat["end"] <= mat["start"] * (1 + 1e-6)
    # ThresholdNow binarises the design block; elsewhere w stays 1 -
    # Porocity
    w = s.lattice.get_quantity("W").numpy()
    block = adj3d_design_block(s.lattice.shape)
    assert set(np.unique(w[block])) <= {0.0, 1.0}
    outside = np.ones(w.shape, bool)
    outside[block] = False
    assert set(np.unique(w[outside])) == {0.5}
    assert any(p.suffix == ".vti" for p in tmp_path.rglob("*"))
    assert bool(torch.isfinite(s.lattice.state.fields).all())


# --------------------------------------------------------------------------- #
# bounds, the device header and the build
# --------------------------------------------------------------------------- #


def test_bound_counts():
    m = get_model(NAME)
    # 20 planes read and written, int32 flags, the three zonal rows
    assert gk.launch_bytes(m, (32, 64, 256)) == \
        164 * 32 * 64 * 256 + 3 * 4 * m.zone_max
    # the backward: primal, lam_out and flags read, lam_in written
    assert ak.launch_bytes_b(m, (32, 64, 256)) == 244 * 32 * 64 * 256
    flags = rich_flags_adj3d(m, *ADJ3D_SHAPE)
    n = flags.size
    coll = gk.count_group(m, flags, "COLLISION")
    macro, collide, nebb, flux = g3._d3q19_adj_counts()
    # by hand: rho 18, j 3 x 9, three divisions
    assert macro == 48
    # each equilibrium 113: |u|^2 5, 1 - 1.5|u|^2 2, three weights, six
    # axis directions 5 each, twelve edges 6 each, the rest 1
    assert g3.equilibrium_flops(d3q19.E, d3q19.W) == 113
    fwd = g3.node_step_flops(m, flags)
    assert fwd > macro * n + collide * coll > 0
    assert ak.node_step_b_flops(m, flags) > 2 * fwd - macro * n
    # bytes bound at bench.py's 32x64x256: 0.0257 and 0.0382 ms at 3.35 TB/s
    assert gk.launch_bytes(m, (32, 64, 256)) / 3.35e12 * 1e3 \
        == pytest.approx(0.0257, abs=5e-5)
    assert ak.launch_bytes_b(m, (32, 64, 256)) / 3.35e12 * 1e3 \
        == pytest.approx(0.0382, abs=5e-5)


def _header() -> str:
    """The model's header with the shared headers it includes
    (d3q19_common.cuh holds the d3q19 tables)."""
    path = _cuda_build.CSRC / gk.DEVICE_MODELS[NAME].header
    return "\n".join(p.read_text() for p in _cuda_build.included(path))


def _enum(text, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def _table(text: str, fn: str) -> np.ndarray:
    body = re.search(r"constexpr \w+ %s\([^)]*\) \{\s*constexpr \w+ t"
                     r"[^=]*= \{(.*?)\};" % fn, text, re.S).group(1)
    items = re.sub(r"[{}\s]", "", body).split(",")
    return np.array([eval(v) for v in items if v])  # noqa: S307


def test_device_header_matches_registry():
    """csrc/models/d3q19_adj.cuh indexes the registry by position: its
    enums list DEVICE_MODELS' names (which check_layout holds against the
    model) and its tables are the model's lattice and basis."""
    text = _header()
    dm = gk.DEVICE_MODELS[NAME]
    m = get_model(NAME)
    gk.check_layout(m)
    assert dm.adjoint and dm.ndim == 3 and "#define TCLB_MODEL_ADJOINT" in text
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    for fn, col in (("ex", 0), ("ey", 1), ("ez", 2)):
        np.testing.assert_array_equal(_table(text, fn), m.ei[:, col])
    np.testing.assert_allclose(_table(text, "wd"), d3q19.W, rtol=1e-15)
    np.testing.assert_array_equal(_table(text, "opp"), d3q19.OPP)
    np.testing.assert_array_equal(_table(text, "mirror_y"),
                                  mirror_perm(d3q19.E, 1))
    lo, hi = d3q19.STRESS
    np.testing.assert_array_equal(_table(text, "basis").reshape(6, 19),
                                  d3q19.M[lo:hi])
    np.testing.assert_array_equal(_table(text, "norm"),
                                  (d3q19.M * d3q19.M).sum(axis=1)[lo:hi])
    assert re.search(r"N_STORAGE = (\d+);", text).group(1) == \
        str(m.n_storage)


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """generic3d.cu builds with the model's header pre-included, the
    shared header and the adjoint header in its digest; editing the
    shared header changes the 2D libraries' digests too."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC, csrc)
    monkeypatch.setattr(_cuda_build, "CSRC", csrc)
    assert [p.name for p in _cuda_build.included(csrc / "generic3d.cu")] \
        == ["generic3d.cu", "generic_common.cuh", "generic3d_adjoint.cuh"]
    assert "--fmad=false" in _cuda_build._flags("generic3d", "h")
    header = gk.DEVICE_MODELS[NAME].header

    def digests():
        return (_cuda_build.digest("generic3d", header),
                _cuda_build.digest("generic2d", "models/d2q9_heat_adj.cuh"))

    before = digests()
    adj = csrc / "generic3d_adjoint.cuh"
    adj.write_text(adj.read_text() + "\n// edited\n")
    edited = digests()
    assert edited[0] != before[0] and edited[1] == before[1]
    common = csrc / "generic_common.cuh"
    common.write_text(common.read_text() + "\n// edited\n")
    assert all(a != b for a, b in zip(digests(), edited))
