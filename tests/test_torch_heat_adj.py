"""The port's d2q9_heat and d2q9_heat_adj against the JAX package's, and
the adjoint slice's kernels through their plain versions.

Same inputs (made from a numpy seed) through both packages: the registry,
the eager step at f64 and f32, the generic engines for d2q9_heat_adj, the
backward (``step_b_plain`` against ``jax.vjp`` of the JAX step, with a
node where ``ux == 0`` and ``w < 1``), and the unsteady gradient against
the JAX package's XLA gradient on the case of
``tests/test_pallas_adjoint.py::test_pallas_heat_adj_gradient``.  The
kernel step (``adjoint_kernels.make_diff_step``) runs its plain versions
here, on CPU tensors; ``tests/test_torch_cuda.py`` holds the kernels
against them on the card.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu import adjoint as jax_adjoint  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_action_step as jax_step  # noqa: E402
from tclb_tpu.core.lattice import make_iterate as jax_iterate  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.adjoint import (InternalTopology,  # noqa: E402
                                    make_objective_run,
                                    make_unsteady_gradient)
from tclb_tpu_torch.core.lattice import make_action_step, pull_stream  # noqa: E402,E501
from tclb_tpu_torch.models.d2q9 import E  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build, lbm  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (HEAT_SETTINGS, HEAT_SHAPE,  # noqa: E402
                         HEAT_ZERO_UX, paint_rich_heat, rich_flags_heat)

NAME = "d2q9_heat_adj"
F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py:69-76
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def settings_for(name):
    m = get_model(name)
    return {k: v for k, v in HEAT_SETTINGS.items() if k in m.setting_index}


def lattice_pair(name, prec, seed=3, shape=HEAT_SHAPE):
    """The same painted state in both packages."""
    jd, td = DTYPES[prec]
    a = JaxLattice(jax_model(name), shape, dtype=jd,
                   settings=settings_for(name))
    b = Lattice(get_model(name), shape, dtype=td,
                settings=settings_for(name), device="cpu")
    return paint_rich_heat(a, seed), paint_rich_heat(b, seed)


# --------------------------------------------------------------------------- #
# registry and eager step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["d2q9_heat", NAME])
def test_registry_matches_reference(name):
    got, want = get_model(name), jax_model(name)
    assert got.storage_names == want.storage_names
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    np.testing.assert_array_equal(got.settings_vector({"nu": 0.05}),
                                  want.settings_vector({"nu": 0.05}))
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
    assert got.structural_key() == want.structural_key()
    assert got.fingerprint == want.fingerprint


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", ["d2q9_heat", NAME])
def test_eager_step_matches_reference(name, prec):
    """One step on the rich 32x64 state: every node type the model reads,
    a non-uniform design field."""
    a, b = lattice_pair(name, prec)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.state.fields, np.float64))
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
    for q in ("Rho", "T", "U", "W", "TB", "WB"):
        np.testing.assert_allclose(b.get_quantity(q).numpy(),
                                   np.asarray(a.get_quantity(q)), **F64_TOL)


# --------------------------------------------------------------------------- #
# the generic engines on d2q9_heat_adj (plain versions)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("engine", ["band", "resident"])
def test_plain_engines_match_reference(engine):
    """Five Iterations on the band engine (four plain launches and one
    globals launch) and the resident one (one 4-step launch and one globals
    launch) against the JAX package's XLA engine, f32."""
    a, b = lattice_pair(NAME, "f32")
    make = gk.make_band_iterate if engine == "band" \
        else gk.make_resident_iterate
    got = make(b.model, HEAT_SHAPE)(b.state, b.params, 5)
    want = jax_iterate(a.model)(a.state, a.params, 5)
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **F32_TOL)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **GLOBALS_TOL)


def test_engine_choice():
    m = get_model(NAME)
    assert gk.select_engine(m, (32, 64), torch.float32)[1] == \
        "cuda_generic_resident[d2q9_heat_adj,fuse=N]"
    # bench.py's heat_adj channel: 19 planes of 512x1024 (79.7 MB) exceed
    # half the L2
    assert gk.select_engine(m, (512, 1024), torch.float32)[1] == \
        "cuda_generic_band[d2q9_heat_adj,fuse=1]"
    assert gk.select_engine(m, (32, 64), torch.float64) == (None, None)
    # d2q9_heat has a device header of its own (no reverse stage)
    assert gk.select_engine(get_model("d2q9_heat"), (32, 64),
                            torch.float32)[1] == \
        "cuda_generic_resident[d2q9_heat,fuse=N]"
    assert not ak.supports_diff(get_model("d2q9_heat"), (32, 64),
                                torch.float32)
    assert ak.supports_diff(m, (512, 1024), torch.float32)
    assert ak.supports_diff(m, (37, 53), torch.float32)   # no alignment
    assert not ak.supports_diff(m, (32, 64), torch.float64)
    assert not ak.supports_diff(get_model("d2q9_kuper"), (32, 64),
                                torch.float32)


def test_one_stage_plan():
    m = get_model(NAME)
    assert gk.action_plan(m) == ([("BaseIteration", 0)], 1)
    assert gk.action_plan(m, fuse=2) == \
        ([("BaseIteration", 1), ("BaseIteration", 0)], 2)
    gk.check_layout(m)


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


def test_zero_ux_node():
    """The rich state's HEAT_ZERO_UX node pulls exactly zero x momentum
    and has w < 1, so its Drag term sits at |ux|'s kink."""
    _, b = lattice_pair(NAME, "f64")
    pulled = pull_stream(b.model, b.state.fields)
    y, x = HEAT_ZERO_UX
    assert float(lbm.edot(E[:, 0], pulled[:9])[y, x]) == 0.0
    assert float(b.state.fields[b.model.storage_index["w"], y, x]) == 0.5
    flag = int(b.flags_numpy()[y, x])
    assert flag & b.model.group_masks["COLLISION"]
    assert flag & b.model.group_masks["DESIGNSPACE"]


@pytest.mark.parametrize("seed", [0, 1])
def test_step_b_plain_matches_jax_vjp(seed):
    """lam_in and the settings cotangent of one Iteration against
    ``jax.vjp`` of the JAX package's step at f64; the Drag cotangent at
    the ux == 0 node follows JAX's |x|' = +1 there."""
    a, b = lattice_pair(NAME, "f64")
    rng = np.random.default_rng(seed)
    lam = rng.standard_normal((b.model.n_storage,) + HEAT_SHAPE)
    lam_g = rng.standard_normal(b.model.n_globals)
    want_in, want_s = _jax_vjp(a, lam, lam_g)
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    ak.reset_launches()
    got_in, got_s = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                              torch.tensor(lam_g))
    assert set(ak.LAUNCHES.values()) == {0}   # plain on the CPU
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               **F64_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **F64_TOL)
    assert got_s.dtype == torch.float64


def test_abs_derivative_at_zero_is_jax_convention():
    """Only the Drag cotangent: at the ux == 0 node the derivative of
    (1 - w) |ux| by the pulled populations is (1 - w) d ux, as with
    |x|' = +1; torch.abs would give 0."""
    a, b = lattice_pair(NAME, "f64")
    lam = np.zeros((b.model.n_storage,) + HEAT_SHAPE)
    lam_g = np.array([0.0, 0.0, 0.0, 1.0])
    want_in, _ = _jax_vjp(a, lam, lam_g)
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    got_in, _ = ak.step_b_plain(f, flags, ztab, args, torch.tensor(lam),
                                torch.tensor(lam_g))
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               **F64_TOL)
    # f[1] streams in from x - e_1: its cotangent there carries the kink
    y, x = HEAT_ZERO_UX
    src = (y, x - 1)
    pulled = pull_stream(b.model, b.state.fields)
    rho = float(pulled[:9, y, x].sum())
    assert float(got_in[1][src]) == pytest.approx(0.5 / rho, rel=1e-12)


# --------------------------------------------------------------------------- #
# the gradient
# --------------------------------------------------------------------------- #


def _gradient_case(prec):
    """tests/test_pallas_adjoint.py::test_pallas_heat_adj_gradient's case:
    16x128, a walled channel with an outlet column and a design block,
    theta = clip(0.7 w + 0.1, 0, 1)."""
    out = []
    for lat_cls, model, dt, kw in (
            (JaxLattice, jax_model(NAME), DTYPES[prec][0], {}),
            (Lattice, get_model(NAME), DTYPES[prec][1], {"device": "cpu"})):
        ny, nx = 16, 128
        lat = lat_cls(model, (ny, nx), dtype=dt,
                      settings={"nu": 0.05, "InletVelocity": 0.02,
                                "FluidAlfa": 0.05, "HeatFluxInObj": 1.0,
                                "DragInObj": 0.3}, **kw)
        flags = np.full((ny, nx), model.flag_for("MRT"), dtype=np.uint16)
        flags[:, 0] = model.flag_for("WVelocity", "MRT")
        flags[:, -1] = model.flag_for("EPressure", "MRT")
        flags[0, :] = flags[-1, :] = model.flag_for("Wall")
        flags[1:-1, -3] = model.flag_for("MRT", "Outlet")
        flags[4:12, 40:80] |= model.flag_for("DesignSpace")
        lat.set_flags(flags)
        lat.init()
        out.append(lat)
    a, b = out
    theta = np.clip(b.fields_raw()[18:19] * 0.7 + 0.1, 0, 1)
    return a, b, theta


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_unsteady_gradient_matches_reference(prec, levels):
    a, b, theta = _gradient_case(prec)
    jd, td = DTYPES[prec]
    ref = jax_adjoint.make_unsteady_gradient(
        a.model, jax_adjoint.InternalTopology(a.model), 8, levels=levels,
        engine="xla")
    obj_r, g_r, fin_r = ref(jnp.asarray(theta, jd), a.state, a.params)
    port = make_unsteady_gradient(b.model, InternalTopology(b.model), 8,
                                  levels=levels, shape=b.shape, dtype=td,
                                  device="cpu")
    assert port.engine_name == "eager"
    obj_p, g_p, fin_p = port(torch.tensor(theta, dtype=td), b.state,
                             b.params)
    g_r = np.asarray(g_r)
    assert np.abs(g_r).max() > 0
    if prec == "f64":
        assert float(obj_p) == pytest.approx(float(obj_r), rel=1e-10)
        np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-9, atol=1e-12)
    else:
        assert float(obj_p) == pytest.approx(float(obj_r), rel=1e-5)
        np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(fin_p.fields.numpy(),
                               np.asarray(fin_r.fields),
                               **(F64_TOL if prec == "f64" else F32_TOL))
    assert fin_p.iteration == 8 and not fin_p.fields.requires_grad


@pytest.mark.parametrize("levels", [1, 2])
def test_kernel_step_matches_eager(levels):
    """The kernel step (its plain versions on CPU tensors): forward
    ``generic2d_step``'s globals flavour, backward ``generic2d_step_b``,
    through ``make_objective_run``'s ``returns_inc``/``prepare`` protocol
    and the checkpointed loop, against the eager step's autograd, f32."""
    _, b, theta = _gradient_case("f32")
    m = b.model
    step = ak.make_diff_step(m, b.shape)
    assert step.engine_name == "cuda_adjoint[d2q9_heat_adj,k=1]"
    assert step.chunk == 1 and step.returns_inc
    design = InternalTopology(m)
    p = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    st, pa = design.put(p, b.state, b.params)
    obj, fin = make_objective_run(m, 8, levels=levels, step=step)(st, pa)
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
    torch.testing.assert_close(fin.globals_.detach(), fin_e.globals_,
                               **GLOBALS_TOL)


def test_engine_selection_without_fallback():
    _, b, _ = _gradient_case("f32")
    m, design = b.model, InternalTopology(b.model)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        make_unsteady_gradient(m, design, 8, engine="cuda", shape=b.shape,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown adjoint engine"):
        make_unsteady_gradient(m, design, 8, engine="pallas",
                               shape=b.shape, device="cpu")
    assert make_unsteady_gradient(m, design, 8, shape=b.shape,
                                  device="cpu").engine_name == "eager"


def test_auto_levels():
    m = get_model(NAME)
    # 19 f32 planes of 512x1024 are 39.8 MB: 1000 of them exceed 6e9
    assert gk.launch_bytes(m, (512, 1024)) > 0
    from tclb_tpu_torch.adjoint import auto_levels
    assert auto_levels(m, (512, 1024), 1000) == 2
    assert auto_levels(m, (512, 1024), 100) == 1
    assert auto_levels(m, (32, 64), 100) == 1


# --------------------------------------------------------------------------- #
# bounds, the device header and the build
# --------------------------------------------------------------------------- #


def test_bound_counts():
    m = get_model(NAME)
    # 19 planes read and written, int32 flags, the Porocity zone table
    assert gk.launch_bytes(m, (512, 1024)) == \
        156 * 512 * 1024 + 4 * m.zone_max
    # the backward: primal, lam_out and flags read, lam_in written
    assert ak.launch_bytes_b(m, (512, 1024)) == 232 * 512 * 1024
    flags = rich_flags_heat(m, *HEAT_SHAPE)
    n = flags.size
    coll = gk.count_group(m, flags, "COLLISION")
    outlet, wvel, epres = (gk.count_types(m, flags, t) for t in
                           ("Outlet", "WVelocity", "EPressure"))
    assert coll and outlet and wvel and epres
    # by hand: every node 2 x 53 (equilibria) + 76, a collision node 91,
    # an outlet 1, a W velocity node 31, an E pressure node 22
    fwd = 182 * n + 91 * coll + outlet + 31 * wvel + 22 * epres
    assert gk.node_step_flops(m, flags) == fwd
    assert ak.node_step_b_flops(m, flags) == \
        fwd + 415 * coll + 68 * n + 40 * wvel + 30 * epres


def _enum(text, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def test_device_header_matches_registry():
    """csrc/models/d2q9_heat_adj.cuh indexes the registry by position."""
    text = (_cuda_build.CSRC / gk.DEVICE_MODELS[NAME].header).read_text()
    dm = gk.DEVICE_MODELS[NAME]
    m = get_model(NAME)
    gk.check_layout(m)
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
