"""The port's 3D heat design family (``d3q19_heat_adj`` and its ``_art``
and ``_prop`` variants) against the JAX package, on the CPU.

Same inputs (made from a numpy seed) through both packages: the registry,
the device header's tables, Init and the eager step at f64 and f32 on an
8x16x32 state that paints every node type the header reads
(``torch_cases.paint_rich_heat3d``), the generic 3D kernels' plain
versions, the plan and engines, the bounds, a JAX state carried over,
and the reference's physics tests (``tests/test_variants.py``) on the
port.  The reverse and the gradients are in
``tests/test_torch_heat_adj3d_grad.py``.  The kernels themselves are held
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
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.adjoint import InternalTopology  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from tclb_tpu_torch.models import d3q19_heat  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic3d_kernels as g3  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (HEAT3D_MODELS, HEAT3D_SHAPE,  # noqa: E402
                         heat3d_settings,
                         paint_rich_heat3d, rich_flags_heat3d)

torch.set_num_threads(1)

F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py:69-76
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
NITER = 3


def lattice_pair(name, prec="f64", seed=3):
    """The same rich state in both packages."""
    jd, td = DTYPES[prec]
    a = JaxLattice(jax_model(name), HEAT3D_SHAPE, dtype=jd,
                   settings=heat3d_settings(jax_model(name)))
    b = Lattice(get_model(name), HEAT3D_SHAPE, dtype=td,
                settings=heat3d_settings(get_model(name)), device="cpu")
    return paint_rich_heat3d(a, seed), paint_rich_heat3d(b, seed)


def copy(state):
    # the JAX engines donate their input state
    return jax.tree.map(jnp.copy, state)


# --------------------------------------------------------------------------- #
# the registry and the device header
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_registry_matches_reference(name):
    got, want = get_model(name), jax_model(name)
    assert got.storage_names == want.storage_names
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    np.testing.assert_array_equal(got.settings_vector(),
                                  want.settings_vector())
    assert {n: (t.value, t.mask) for n, t in got.node_types.items()} == \
        {n: (t.value, t.mask) for n, t in want.node_types.items()}
    assert got.group_masks == want.group_masks
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


def _variant_text(name: str) -> str:
    """The common header as the variant's build sees it: the branch of
    each ``#if HEAT_ADJ_VARIANT == 2`` its define takes."""
    thin = (_cuda_build.CSRC / gk.DEVICE_MODELS[name].header).read_text()
    v = int(re.search(r"#define HEAT_ADJ_VARIANT (\d)", thin).group(1))
    text = (_cuda_build.CSRC / "models"
            / "d3q19_heat_adj_common.cuh").read_text()
    prop = v == 2

    def pick(mt):
        return mt.group(1) if prop else (mt.group(2) or "")
    return re.sub(r"#if HEAT_ADJ_VARIANT == 2\n(.*?)(?:#else\n(.*?))?#endif",
                  pick, text, flags=re.S), v


def _enum(text: str, name: str) -> list:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def _table(text: str, fn: str) -> np.ndarray:
    body = re.search(r"constexpr \w+ %s\([^)]*\) \{\s*constexpr \w+ t"
                     r"[^=]*= \{(.*?)\};" % fn, text, re.S).group(1)
    return np.array([eval(v) for v in body.replace("\n", "").split(",")  # noqa: S307,E501
                     if v.strip()])


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_device_header_matches_registry(name):
    """Each variant's build of d3q19_heat_adj_common.cuh: its enums list
    DEVICE_MODELS' names (which check_layout holds against the model), its
    velocity tables the model's, its d3q7 weights and pairs
    models/d3q19_heat.py's, its write set the planes the stage stores, and
    its variant define the one DEVICE_MODELS' header names."""
    dm = gk.DEVICE_MODELS[name]
    m = get_model(name)
    gk.check_layout(m)
    text, v = _variant_text(name)
    assert v == {"d3q19_heat_adj": 0, "d3q19_heat_adj_art": 1,
                 "d3q19_heat_adj_prop": 2}[name]
    for enum, prefix, names in (("Setting", "S_", dm.settings),
                                ("NodeType", "T_", dm.node_types),
                                ("Group", "G_", dm.groups),
                                ("Zonal", "Z_", dm.zonal),
                                ("Global", "GL_", dm.globals_)):
        assert _enum(text, enum) == [prefix + s for s in names], enum
    n = m.n_storage
    for a, fn in enumerate(("ex", "ey", "ez")):
        np.testing.assert_array_equal(_table(text, fn)[:n], m.ei[:, a])
    np.testing.assert_allclose(_table(text, "wt"), d3q19_heat.WT,
                               rtol=1e-15)
    np.testing.assert_array_equal(_table(text, "oppt"), d3q19_heat.OPPT)
    mask = int(re.search(r"return PROP \? (0x[0-9a-f]+)u : (0x[0-9a-f]+)u",
                         text).group(1 if v == 2 else 2), 16)
    written = set(m.groups["f"]) | set(m.groups["T"]) | (
        set(m.groups["wm"]) if v == 2 else set())
    assert mask == sum(1 << i for i in written)
    assert dm.adjoint and dm.ndim == 3 and dm.plan == (("BaseIteration", 0),)
    assert "#define TCLB_MODEL_ADJOINT 1" in text and "stage_b<" in text


# --------------------------------------------------------------------------- #
# Init and the eager step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_init_matches_reference(name):
    """Init alone (the rich flags, zone 1's Porocity and Velocity, no
    noise) at f64: the equilibria, w = 1 - Porocity (0 on Solid) and
    _prop's pair."""
    ja = JaxLattice(jax_model(name), HEAT3D_SHAPE, dtype=jnp.float64,
                    settings=heat3d_settings(jax_model(name)))
    tb = Lattice(get_model(name), HEAT3D_SHAPE, dtype=torch.float64,
                 settings=heat3d_settings(get_model(name)), device="cpu")
    for lat in (ja, tb):
        lat.set_flags(rich_flags_heat3d(lat.model, *HEAT3D_SHAPE))
        lat.set_setting("Velocity", 0.03, zone=1)
        lat.set_setting("Porocity", 0.2, zone=1)
        lat.init()
    np.testing.assert_allclose(tb.fields_raw(), np.asarray(ja.state.fields),
                               **F64_TOL)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_eager_step_matches_reference(name, prec):
    """NITER steps on the rich 8x16x32 state against the JAX package's
    XLA engine: f64 at rtol 1e-10 / atol 1e-12, f32 at the engines'
    tolerances; every global counts; at f64 also every quantity."""
    a, b = lattice_pair(name, prec)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.state.fields, np.float64))
    flags = b.flags_numpy()
    for t in ("WVelocity", "WPressure", "EVelocity", "EPressure",
              "NSymmetry", "SSymmetry", "Wall", "Solid", "BGK", "MRT",
              "Outlet", "DesignSpace") + (
                  ("Propagate",) if "Propagate" in b.model.node_types
                  else ()):
        assert gk.count_types(b.model, flags, t), t
    want = jax_iterate(a.model)(copy(a.state), a.params, NITER)
    got = make_iterate(b.model)(b.state, b.params, NITER)
    f64 = prec == "f64"
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **(F64_TOL if f64 else F32_TOL))
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_),
                               **(F64_TOL if f64 else GLOBALS_TOL))
    assert np.all(np.asarray(want.globals_)[3:] != 0)
    if f64:
        for q in b.model.quantities:
            np.testing.assert_allclose(
                b.get_quantity(q.name).numpy(),
                np.asarray(a.get_quantity(q.name)), **F64_TOL,
                err_msg=q.name)


# --------------------------------------------------------------------------- #
# the kernels' plain versions, the plan and the bounds
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_kernels_plain_versions(name):
    """``generic3d_step`` (both flavours) and ``generic3d_step_series``
    on CPU tensors are their plain versions, the eager step; no launch is
    counted."""
    _, b = lattice_pair(name, "f32")
    f, flags, ztab, a = g3.kernel_inputs(b.model, b.state, b.params)
    g3.reset_launches()
    one = make_iterate(b.model)(b.state, b.params, 1)
    np.testing.assert_allclose(g3.step(f, flags, ztab, a).numpy(),
                               one.fields.numpy(), **F32_TOL)
    out, g = g3.step_globals(f, flags, ztab, a)
    np.testing.assert_allclose(out.numpy(), one.fields.numpy(), **F32_TOL)
    np.testing.assert_allclose(g.numpy(), one.globals_.numpy(),
                               **GLOBALS_TOL)
    assert set(g3.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_plan_and_engines(name):
    """One stage of reach 1 (the reference's plan), K6's band engine at
    f32 (none at f64, bf16 eager by selection), and the kernel adjoint
    (K8) at f32: ``cuda_adjoint3d[<model>,k=1]``."""
    from tclb_tpu.ops import pallas_generic
    m = get_model(name)
    assert gk.action_plan(m) == pallas_generic.action_plan(
        jax_model(name)) == ([("BaseIteration", 0)], 1)
    shape = (32, 64, 256)
    assert g3.supports(m, shape, torch.float32)
    assert g3.select_engine(m, shape, torch.float32)[1] == \
        f"cuda_generic3d_band[{name},fuse=1]"
    assert g3.select_engine(m, shape, torch.float64) == (None, None)
    assert ak.supports_diff(m, shape, torch.float32)
    assert not ak.supports_diff(m, shape, torch.float32,
                                storage_dtype=torch.bfloat16)
    assert ak.make_diff_step(m, shape).engine_name == \
        f"cuda_adjoint3d[{name},k=1]"


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_bound_counts(name):
    """Bytes: every plane read and written and the int32 flags a node (27
    or 29 planes), the zone table once; the reverse's the primal, both
    cotangents and the flags ((3 n + 1) 4 B a node: 0.0514 ms at
    32x64x256 on 3.35 TB/s, 0.0551 for _prop); operations by node kind,
    the reverse's above the forward's."""
    m = get_model(name)
    n = 32 * 64 * 256
    zonal = len(m.zonal_settings) * m.zone_max * 4
    assert g3.launch_bytes(m, (32, 64, 256)) == \
        (8 * m.n_storage + 4) * n + zonal
    assert ak.launch_bytes_b(m, (32, 64, 256)) == (12 * m.n_storage + 4) * n
    ms = ak.launch_bytes_b(m, (32, 64, 256)) / 3.35e12 * 1e3
    assert ms == pytest.approx(0.0551 if name.endswith("_prop")
                               else 0.0514, abs=1e-4)
    flags = rich_flags_heat3d(m, *HEAT3D_SHAPE)
    fwd = g3.node_step_flops(m, flags)
    assert fwd == sum(g3.stage_flops(m, flags)) > 0
    assert ak.node_step_b_flops(m, flags) > 2 * fwd


@pytest.mark.parametrize("name", HEAT3D_MODELS)
def test_state_carries_over(name):
    """The JAX package's state and params cross with no model-specific
    code (w, and _prop's w0 and w1, with them), both ways, at f64 and f32;
    InternalTopology reads the JAX package's design vector."""
    a, b = lattice_pair(name, "f64")
    m = get_model(name)
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
    assert InternalTopology(m).names == ("w",)


# --------------------------------------------------------------------------- #
# the reference's physics tests on the port
# --------------------------------------------------------------------------- #


def _heat_channel(name, w_val, niter=400):
    """tests/test_variants.py's heat channel (4x10x24, walls on y, W
    velocity inlet, E pressure outlet, a design block of w = w_val) on
    the port's eager f64 engine."""
    m = get_model(name)
    shape = (4, 10, 24)
    lat = Lattice(m, shape, dtype=torch.float64, device="cpu",
                  settings={"nu": 0.1, "Velocity": 0.05,
                            "InletTemperature": 1.0,
                            "InitTemperature": 0.0})
    flags = np.full(shape, m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0, :] = m.flag_for("Wall")
    flags[:, -1, :] = m.flag_for("Wall")
    flags[:, 1:-1, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, 1:-1, -1] = m.flag_for("EPressure", "MRT")
    lat.set_flags(flags)
    lat.init()
    w = np.ones(shape)
    w[:, 3:7, 8:14] = w_val
    lat.set_density_planes({"w": w})
    lat.iterate(niter)
    return lat, lat.get_quantity("U").numpy()


def test_art_momentum_factor_differs():
    """tests/test_variants.py:89-104: _art's 2 w - 1 momentum factor kills
    the momentum at w = 0.5 (the base keeps half), so flow through the
    block is much weaker; at w = 1 the two variants coincide."""
    _, u_base = _heat_channel("d3q19_heat_adj", 0.5)
    _, u_art = _heat_channel("d3q19_heat_adj_art", 0.5)
    assert np.isfinite(u_base).all() and np.isfinite(u_art).all()
    blk = (slice(None), slice(3, 7), slice(8, 14))
    v_base = np.abs(u_base[0][blk]).mean()
    v_art = np.abs(u_art[0][blk]).mean()
    assert v_art < 0.5 * v_base, (v_art, v_base)
    _, ub1 = _heat_channel("d3q19_heat_adj", 1.0)
    _, ua1 = _heat_channel("d3q19_heat_adj_art", 1.0)
    np.testing.assert_allclose(ua1, ub1, atol=1e-12)


def test_prop_propagates_design_downstream():
    """tests/test_variants.py:106-134: with PropagateX > 0 on Propagate
    nodes, solid material (w = 0) shades the nodes downstream (+x): w0
    drops behind the block and stays 1 far upstream; MaterialPenalty is
    finite."""
    m = get_model("d3q19_heat_adj_prop")
    shape = (4, 10, 24)
    lat = Lattice(m, shape, dtype=torch.float64, device="cpu",
                  settings={"nu": 0.1, "Velocity": 0.02, "PropagateX": 0.8,
                            "InletTemperature": 1.0,
                            "InitTemperature": 0.0})
    lat.set_flags(np.full(shape, m.flag_for("MRT", "Propagate"),
                          dtype=np.uint16))
    lat.init()
    w = np.ones(shape)
    w[:, 4:6, 6:8] = 0.0
    lat.set_density_planes({"w": w})
    lat.iterate(10)
    w0 = lat.fields_raw()[m.storage_index["w0"]]
    assert np.isfinite(w0).all()
    assert w0[2, 5, 10] < 0.8, w0[2, 5, 10]
    np.testing.assert_allclose(w0[2, 5, 2], 1.0, atol=1e-6)
    g = lat.get_globals()
    assert "MaterialPenalty" in g and np.isfinite(g["MaterialPenalty"])
