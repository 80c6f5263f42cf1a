"""The port's ``d2q9_kuper_adj`` against the JAX package, on the CPU.

Same inputs (made from a numpy seed) through both packages: the registry,
Init and the eager step at f64 and f32 on the kuper rich state with a
DesignSpace block and a design density wd in (0.5, 1.5)
(``torch_cases.paint_rich_kuper_adj``), the device header's build of
d2q9_kuper.cuh, the plain versions of ``generic2d_step`` (both flavours)
and ``generic2d_resident`` against the eager step and the JAX package's
generic band engine in interpret mode, the plan and engines, the bounds,
a JAX state carried over with wd, and the reference's
``tests/test_models.py:test_kuper_adj_init_and_step``.  The reverse is in
``tests/test_torch_kuper_adj_grad.py``.  The kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
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
from tclb_tpu.core.lattice import make_iterate as jax_iterate  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_generic  # noqa: E402
from tclb_tpu.ops.lbm import present_types as jax_present  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.adjoint import InternalTopology  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (KUPER_ADJ_SETTINGS, KUPER_SHAPE,  # noqa: E402
                         paint_rich_kuper_adj)

torch.set_num_threads(1)

NAME = "d2q9_kuper_adj"
F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py:69-76
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
NITER = 3
# f32 against the JAX package: one step (its collision passes the
# post-force equilibrium through the moment basis, the port's takes it
# directly, so the two round apart, and three steps of the rich state's
# wd-scaled forces carry that past the engines' tolerance on one node)
NITER_F32 = 1


def lattice_pair(prec="f64", seed=3):
    """The same rich state in both packages: painted in each, the JAX
    package's fields then copied into the port's (the two Inits' phi
    differ in the last bit on a few nodes)."""
    jd, td = DTYPES[prec]
    a = paint_rich_kuper_adj(JaxLattice(jax_model(NAME), KUPER_SHAPE,
                                        dtype=jd,
                                        settings=KUPER_ADJ_SETTINGS), seed)
    b = paint_rich_kuper_adj(Lattice(get_model(NAME), KUPER_SHAPE, dtype=td,
                                     settings=KUPER_ADJ_SETTINGS,
                                     device="cpu"), seed)
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               rtol=1e-6 if prec == "f32" else 1e-15)
    b.state.fields.copy_(torch.tensor(np.asarray(a.state.fields)))
    return a, b


def copy(state):
    # the JAX engines donate their input state
    return jax.tree.map(jnp.copy, state)


def assert_state(got, want, tol=F32_TOL, gtol=GLOBALS_TOL):
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **tol)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **gtol)


def test_registry_matches_reference():
    got, want = get_model(NAME), jax_model(NAME)
    assert got.storage_names == want.storage_names
    np.testing.assert_array_equal(got.ei, want.ei)
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    assert {n: (t.value, t.mask) for n, t in got.node_types.items()} == \
        {n: (t.value, t.mask) for n, t in want.node_types.items()}
    assert [(g.name, g.op) for g in got.globals_] == \
        [(g.name, g.op) for g in want.globals_]
    assert [(q.name, q.vector, q.adjoint) for q in got.quantities] == \
        [(q.name, q.vector, q.adjoint) for q in want.quantities]
    assert [(f.name, f.dx_range, f.dy_range, f.parameter)
            for f in got.fields] == \
        [(f.name, f.dx_range, f.dy_range, f.parameter) for f in want.fields]
    assert [(d.name, d.parameter) for d in got.densities] == \
        [(d.name, d.parameter) for d in want.densities]
    assert got.actions == want.actions
    assert got.structural_key() == want.structural_key()
    assert got.fingerprint == want.fingerprint


def test_init_and_eager_steps_match_reference():
    """Init (wd = 1, phi from CalcPhi) at f64, then NITER eager steps on
    the rich state at f64 (rtol 1e-10 / atol 1e-12) and f32 (the engines'
    tolerances) against the JAX package's XLA engine, globals included;
    every quantity at f64."""
    ja = JaxLattice(jax_model(NAME), KUPER_SHAPE, dtype=jnp.float64,
                    settings=KUPER_ADJ_SETTINGS)
    tb = Lattice(get_model(NAME), KUPER_SHAPE, dtype=torch.float64,
                 settings=KUPER_ADJ_SETTINGS, device="cpu")
    for lat in (ja, tb):
        lat.set_flags(np.full(KUPER_SHAPE, lat.model.flag_for("MRT"),
                              np.uint16))
        lat.init()
    np.testing.assert_allclose(tb.fields_raw(), np.asarray(ja.state.fields),
                               **F64_TOL)
    assert tb.fields_raw()[tb.model.storage_index["wd"]].min() == 1.0
    for prec in ("f64", "f32"):
        a, b = lattice_pair(prec)
        np.testing.assert_array_equal(
            b.fields_raw(), np.asarray(a.state.fields, np.float64))
        n = NITER if prec == "f64" else NITER_F32
        want = jax_iterate(a.model)(copy(a.state), a.params, n)
        got = make_iterate(b.model)(b.state, b.params, n)
        if prec == "f64":
            assert_state(got, want, F64_TOL, F64_TOL)
            for q in b.model.quantities:
                np.testing.assert_allclose(
                    b.get_quantity(q.name).numpy(),
                    np.asarray(a.get_quantity(q.name)), **F64_TOL,
                    err_msg=q.name)
        else:
            assert_state(got, want)
        assert np.all(np.asarray(want.globals_) != 0)


def test_kernels_plain_versions():
    """The kernels' plain versions on CPU tensors against the eager step
    they are: ``step`` and ``step_globals`` one Iteration, ``resident``
    eight, from the rich state; no launch counted."""
    _, b = lattice_pair("f32")
    f, flags, ztab, a = gk.kernel_inputs(b.model, b.state, b.params)
    gk.reset_launches()
    one = make_iterate(b.model)(b.state, b.params, 1)
    eight = make_iterate(b.model)(b.state, b.params, 8)
    np.testing.assert_allclose(gk.step(f, flags, ztab, a).numpy(),
                               one.fields.numpy(), **F32_TOL)
    out, g = gk.step_globals(f, flags, ztab, a)
    np.testing.assert_allclose(out.numpy(), one.fields.numpy(), **F32_TOL)
    np.testing.assert_allclose(g.numpy(), one.globals_.numpy(),
                               **GLOBALS_TOL)
    np.testing.assert_allclose(gk.resident(f, flags, ztab, a, 8).numpy(),
                               eight.fields.numpy(), **F32_TOL)
    assert set(gk.LAUNCHES.values()) == {0}


def test_plain_engines_match_pallas():
    """NITER_F32 f32 Iterations of the port's plain band and resident
    engines against the JAX package's generic band engine in interpret
    mode and its XLA engine, fields and the last step's globals."""
    a, b = lattice_pair("f32")
    present = jax_present(a.model, a._host_flags)
    want = pallas_generic.make_pallas_iterate(
        a.model, KUPER_SHAPE, jnp.float32, interpret=True,
        present=present)(copy(a.state), a.params, NITER_F32)
    xla = jax_iterate(a.model)(copy(a.state), a.params, NITER_F32)
    band = gk.make_band_iterate(b.model, KUPER_SHAPE)
    res = gk.make_resident_iterate(b.model, KUPER_SHAPE)
    for got in (band(b.state, b.params, NITER_F32),
                res(b.state, b.params, NITER_F32)):
        assert_state(got, want)
        assert_state(got, xla)


def _enum(text: str, name: str) -> list:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def test_device_header_matches_registry():
    """d2q9_kuper_adj.cuh builds d2q9_kuper.cuh with KUPER_DESIGN: the
    enums (d2q9_kuper's) list DEVICE_MODELS' names, which check_layout
    holds against the model; wd and phi are planes 9 and 10, phi the one
    CalcPhi writes; its Field reads (``b_loads``): Run's eight, phi at
    -e_i for i = 1..8, CalcPhi's none; both stages have a reverse."""
    dm = gk.DEVICE_MODELS[NAME]
    m = get_model(NAME)
    gk.check_layout(m)
    base = (_cuda_build.CSRC / "models" / "d2q9_kuper.cuh").read_text()
    text = (_cuda_build.CSRC / dm.header).read_text()
    for enum, prefix, names in (("Setting", "S_", dm.settings),
                                ("NodeType", "T_", dm.node_types),
                                ("Group", "G_", dm.groups),
                                ("Zonal", "Z_", dm.zonal),
                                ("Global", "GL_", dm.globals_)):
        assert _enum(base, enum) == [prefix + s for s in names], enum
    design = re.search(r"#ifdef KUPER_DESIGN\n(.*?)#else", base,
                       re.S).group(1)
    assert "constexpr int N_STORAGE = 11;" in design
    assert "constexpr int WD = 9, PHI = 10;" in design
    assert (m.storage_index["wd"], m.storage_index["phi"]) == (9, 10)
    assert "#define KUPER_DESIGN 1" in text
    assert "#define TCLB_MODEL_ADJOINT 1" in text
    assert "return s == 0 ? 8 : 0;" in text
    assert "stage_b<" in text and "calc_phi_b(c)" in text
    assert "constexpr int load_k(int, int) { return PHI; }" in text
    assert "return -ex(j + 1);" in text and "return -ey(j + 1);" in text
    assert dm.adjoint and dm.plan == (("BaseIteration", 1), ("CalcPhi", 0))


def test_plan_and_engines():
    """The reference's plan, K4's ring form (11 planes: 45,056 B of shared
    memory), the resident engine where the stacks fit half the L2, the
    band engine at 1024x1024, nothing at f64, bf16 named in the tag; the
    kernel adjoint (K7's two-stage reverse): ``cuda_adjoint[d2q9_kuper_adj,
    k=1]`` at f32, not on a bf16 stack; its reverse tiles (stage 0's q: 11
    planes and 8 Field reads, 77,824 B on 256 threads; stage 1's 11 planes
    on 512: the slots the library reports, ``generic2d_step_b_slots``)."""
    m = get_model(NAME)
    assert gk.action_plan(m) == pallas_generic.action_plan(
        jax_model(NAME)) == ([("BaseIteration", 1), ("CalcPhi", 0)], 2)
    assert gk.step_form(m) == "ring"
    assert gk.ring_tile(m)["smem"] == 45056
    assert gk.select_engine(m, (128, 128), torch.float32)[1] == \
        f"cuda_generic_resident[{NAME},fuse=N]"
    assert gk.select_engine(m, (1024, 1024), torch.float32)[1] == \
        f"cuda_generic_band[{NAME},fuse=1]"
    assert gk.select_engine(m, (128, 128), torch.float64) == (None, None)
    assert gk.select_engine(m, (1024, 1024), torch.float32,
                            storage_dtype=torch.bfloat16,
                            storage_repr="shifted")[1] == \
        f"cuda_generic_band[{NAME},fuse=1,bfloat16/shifted]"
    assert ak.supports_diff(m, (1024, 1024), torch.float32)
    assert not ak.supports_diff(m, (1024, 1024), torch.float32,
                                storage_dtype=torch.bfloat16)
    assert ak.make_diff_step(m, (1024, 1024)).engine_name == \
        f"cuda_adjoint[{NAME},k=1]"
    t0, t1 = gk.step_b_tile(m, 11 + 8), gk.step_b_tile(m, 11)
    assert (t0["smem"], t0["threads"]) == (77824, 256)
    assert (t1["smem"], t1["threads"]) == (45056, 512)
    assert t0["tile"] == t1["tile"] == (30, 30)


def test_bound_counts():
    """Bytes: every plane read and written and the int32 flags a node
    (11 planes, 92 B), the zone table once; the reverse's the primal, both
    cotangents and the flags ((3 x 11 + 1) 4 B a node: 0.0426 ms at
    1024x1024 on 3.35 TB/s); operations: d2q9_kuper's and wd's product a
    node, the reverse's above the forward's."""
    m, k = get_model(NAME), get_model("d2q9_kuper")
    n = 1024 * 1024
    zonal = len(m.zonal_settings) * m.zone_max * 4
    assert gk.launch_bytes(m, (1024, 1024)) == 92 * n + zonal
    assert ak.launch_bytes_b(m, (1024, 1024)) == 136 * n
    assert ak.launch_bytes_b(m, (1024, 1024)) / 3.35e12 * 1e3 == \
        pytest.approx(0.0426, abs=1e-4)
    _, b = lattice_pair("f32")
    flags = b.flags_numpy()
    assert gk.node_step_flops(m, flags) == \
        gk.node_step_flops(k, flags) + flags.size
    assert ak.node_step_b_flops(m, flags) > 2 * gk.node_step_flops(m, flags)


def test_state_carries_over():
    """The JAX package's state crosses with no model-specific code, wd
    with it, both ways at f64 and f32; InternalTopology reads wd."""
    a, b = lattice_pair("f64")
    m = get_model(NAME)
    for dt in (np.float64, np.float32):
        fields = np.asarray(a.state.fields).astype(dt)
        state, params = state_from_numpy(
            m, fields, np.asarray(a.state.flags),
            np.asarray(a.state.globals_), 3, np.asarray(a.params.settings),
            np.asarray(a.params.zone_table), device="cpu")
        back = state_to_numpy(state, params)
        np.testing.assert_array_equal(back["fields"], fields)
    theta = jax_adjoint.InternalTopology(a.model).get(a.state, a.params)
    np.testing.assert_array_equal(
        InternalTopology(m).get(b.state, b.params).numpy(),
        np.asarray(theta))
    assert InternalTopology(m).names == ("wd",)


def test_kuper_adj_init_and_step():
    """tests/test_models.py:test_kuper_adj_init_and_step on the port:
    Init writes wd = 1 through d2q9_kuper's init, five steps stay finite,
    and Init runs again."""
    m = get_model(NAME)
    lat = Lattice(m, (16, 16), dtype=torch.float64, device="cpu",
                  settings={"nu": 0.18, "Temperature": 0.56,
                            "Density": 3.26, "Magic": 0.01, "FAcc": 1.0})
    lat.set_flags(np.full((16, 16), m.flag_for("MRT"), dtype=np.uint16))
    lat.init()
    assert float(lat.fields_raw()[m.storage_index["wd"]].min()) == 1.0
    lat.iterate(5)
    assert np.isfinite(lat.get_quantity("Rho").numpy()).all()
    lat.init()
