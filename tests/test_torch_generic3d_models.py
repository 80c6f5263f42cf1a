"""The 3D models of the port's generic engine (``d3q19_heat``, ``d3q27``,
``d3q27_viscoplastic``, ``d3q27_cumulant_qibb_small``, ``d3q19_kuper``)
against the JAX package, on the CPU.

For each model: the registry and the stage plan, the device header's enums
and tables against ``DEVICE_MODELS`` and the model, Init and the eager step
against the JAX package's XLA engine at f64 (RTOL 1e-10 / ATOL 1e-12) with
every quantity, the plain versions of ``generic3d_step`` (both flavours,
the band engine) at f64 and f32 (tests/test_fastpath.py's tolerances) on a
rich state (every node type the header reads, two zones with their own
zonal values, 2% noise, qibb's cuts painted from a sphere, kuper's phi not
constant), the engine choice and the bound counts.  d3q19_heat and
d3q19_kuper are also held against ``pallas_generic`` in interpret mode at
the reference's own pin shapes (tests/test_pallas_generic.py:361-382,
the 12x16x128 straddle case included).  The kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import functools  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_iterate as jax_make_iterate  # noqa: E402,E501
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_generic  # noqa: E402
from tclb_tpu.ops.lbm import present_types as jax_present  # noqa: E402
from tclb_tpu.utils import geometry as jax_geometry  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from tclb_tpu_torch.models import d3q19  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build, cumulant, lbm  # noqa: E402
from tclb_tpu_torch.ops import d3q27_kernels as dk3  # noqa: E402
from tclb_tpu_torch.ops import generic3d_kernels as g3  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from tclb_tpu_torch.utils import geometry  # noqa: E402
from torch_cases import (GENERIC3D_MODELS, GENERIC3D_SETTINGS,  # noqa: E402
                         GENERIC3D_SHAPE, RICH_GENERIC3D_SETTINGS,
                         paint_rich_generic3d, parity3d_flags)

# One PyTorch intra-op thread per process, as the other port test files
# (pytest-xdist imports every test file into each worker)
torch.set_num_threads(1)

F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py:69-76
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
NITER = 3


def _types(name):
    return gk.DEVICE_MODELS[name].node_types


@functools.lru_cache(maxsize=None)
def _jax_lattice(name, prec, seed=3):
    """The rich state in the JAX package (built once per model, precision
    and seed; the engines below copy its state, and no test changes
    it)."""
    lat = JaxLattice(jax_model(name), GENERIC3D_SHAPE, dtype=DTYPES[prec][0],
                     settings=RICH_GENERIC3D_SETTINGS[name])
    return paint_rich_generic3d(lat, _types(name), seed)


def lattice_pair(name, prec="f32", seed=3):
    """The same rich state in both packages (the port's made anew)."""
    b = Lattice(get_model(name), GENERIC3D_SHAPE, dtype=DTYPES[prec][1],
                settings=RICH_GENERIC3D_SETTINGS[name], device="cpu")
    return (_jax_lattice(name, prec, seed),
            paint_rich_generic3d(b, _types(name), seed))


def _copy(state):
    # the JAX engines donate their input state
    return jax.tree.map(jnp.copy, state)


def _assert_state(got, want, tol=F32_TOL, gtol=GLOBALS_TOL):
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **tol)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **gtol)
    assert got.iteration == int(want.iteration)


# --------------------------------------------------------------------------- #
# registry, Init, eager step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_registry_matches_reference(name):
    got, want = get_model(name), jax_model(name)
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
    assert [(f.name, f.dx_range, f.dy_range, f.dz_range)
            for f in got.fields] == \
        [(f.name, f.dx_range, f.dy_range, f.dz_range) for f in want.fields]
    assert got.actions == want.actions
    assert got.fingerprint == want.fingerprint


@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_init_and_eager_step_match_reference(name):
    """Init on the rich flags (the planes before the noise) and NITER eager
    steps in f64 against the JAX package's XLA engine, globals included;
    then every quantity."""
    m, jm = get_model(name), jax_model(name)
    a = JaxLattice(jm, GENERIC3D_SHAPE, dtype=jnp.float64,
                   settings=RICH_GENERIC3D_SETTINGS[name])
    b = Lattice(m, GENERIC3D_SHAPE, dtype=torch.float64,
                settings=RICH_GENERIC3D_SETTINGS[name], device="cpu")
    for lat in (a, b):
        paint_rich_generic3d(lat, _types(name), seed=3)
    # Init: paint again without the planes' noise
    flags = b.flags_numpy()
    for lat in (a, b):
        lat.set_flags(flags)
        if "q" in m.groups:       # the cuts survive Init, as painted
            continue
        lat.init()
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               **F64_TOL)
    for lat in (a, b):
        paint_rich_generic3d(lat, _types(name), seed=3)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.state.fields, np.float64))
    want = jax_make_iterate(a.model)(_copy(a.state), a.params, NITER)
    got = make_iterate(b.model)(b.state, b.params, NITER)
    _assert_state(got, want, F64_TOL, F64_TOL)
    assert np.abs(np.asarray(want.globals_)).sum() > 0 \
        or not len(m.globals_) or name == "d3q27"
    b.state, a.state = got, want
    for q in b.model.quantities:
        np.testing.assert_allclose(
            b.get_quantity(q.name).numpy(),
            np.asarray(a.get_quantity(q.name)), **F64_TOL, err_msg=q.name)


def test_qibb_init_keeps_the_cuts():
    """Init keeps the painted cut distances (static geometry) and sets the
    populations as the reference does."""
    name = "d3q27_cumulant_qibb_small"
    a = paint_rich_generic3d(
        JaxLattice(jax_model(name), GENERIC3D_SHAPE, dtype=jnp.float64,
                   settings=RICH_GENERIC3D_SETTINGS[name]), _types(name), 3)
    _, b = lattice_pair(name, "f64")
    before = b.fields_raw().copy()
    a.init()
    b.init()
    q0 = b.model.storage_index["q[1]"]
    np.testing.assert_array_equal(b.fields_raw()[q0:], before[q0:])
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               **F64_TOL)


def test_cuts_from_sdf_match_reference():
    """The port's cut painter on a sphere (and a cylinder) equals the
    reference's."""
    E = cumulant.velocity_set(3)
    for sdf_args, shape in (((6.0, 6.2, 5.9), 3.3), (12, 12, 12)), \
            (((5.5, 7.0), 2.6), (4, 12, 14)):
        got = geometry.cuts_from_sdf(geometry.sphere_sdf(*sdf_args), shape,
                                     E)
        want = jax_geometry.cuts_from_sdf(jax_geometry.sphere_sdf(*sdf_args),
                                          shape, E)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).any()


# --------------------------------------------------------------------------- #
# the plain versions of the kernel, the engine
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_plain_kernel_matches_reference(name, prec):
    """``generic3d_step`` (plain launches, then the globals flavour) on the
    CPU, its plain version, for NITER steps against the JAX package's XLA
    engine; at f32 also the band engine ``Lattice`` picks on the card."""
    a, b = lattice_pair(name, prec)
    tol = F64_TOL if prec == "f64" else F32_TOL
    gtol = F64_TOL if prec == "f64" else GLOBALS_TOL
    want = jax_make_iterate(a.model)(_copy(a.state), a.params, NITER)
    f, flags, ztab, args = g3.kernel_inputs(b.model, b.state, b.params)
    g3.reset_launches()
    for _ in range(NITER - 1):
        f = g3.step(f, flags, ztab, args)
    f, g = g3.step_globals(f, flags, ztab, args)
    assert g3.LAUNCHES == {"generic3d_step": 0}     # plain on the CPU
    np.testing.assert_allclose(f.numpy(), np.asarray(want.fields), **tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(want.globals_), **gtol)
    if prec == "f32":
        band = g3.make_band_iterate(b.model, GENERIC3D_SHAPE)
        assert band.full_globals and band.supports_series
        _assert_state(band(b.state, b.params, NITER), want)


# the reference's pins of K6 (tests/test_pallas_generic.py:361-382): the
# two key models at (6, 16, 128), kuper's halo straddle at (12, 16, 128)
PINS = [("d3q19_heat", (6, 16, 128)), ("d3q19_kuper", (6, 16, 128)),
        ("d3q19_kuper", (12, 16, 128))]


@pytest.mark.parametrize("name,shape", PINS)
def test_plain_engine_matches_pallas(name, shape):
    """The reference's ``_parity_3d``: the collision type with Wall rows,
    its settings, Init, 4 steps of ``pallas_generic`` in interpret mode
    against the port's plain band engine (and the XLA engine), fields and
    globals."""
    niter = 4
    a = JaxLattice(jax_model(name), shape, dtype=jnp.float32,
                   settings=GENERIC3D_SETTINGS[name])
    b = Lattice(get_model(name), shape, dtype=torch.float32,
                settings=GENERIC3D_SETTINGS[name], device="cpu")
    flags = parity3d_flags(b.model, shape)
    for lat in (a, b):
        lat.set_flags(flags)
        lat.init()
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               **F32_TOL)
    present = jax_present(a.model, flags)
    want = pallas_generic.make_pallas_iterate(
        a.model, shape, jnp.float32, interpret=True,
        present=present)(_copy(a.state), a.params, niter)
    got = g3.make_band_iterate(b.model, shape)(b.state, b.params, niter)
    _assert_state(got, want)
    _assert_state(got, jax_make_iterate(a.model)(_copy(a.state), a.params,
                                                 niter))
    assert np.isfinite(got.fields.numpy()).all()


@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_stage_plan_and_engine_choice(name):
    """The reference's plan; the generic 3D band engine at f32 under the
    model's tag at bench.py's 48x48x256 and small shapes, not the z-slab
    kernels; nothing at f64 or on a bf16 stack (K6 has no bf16 rung)."""
    m, jm = get_model(name), jax_model(name)
    gk.check_layout(m)
    plan = gk.action_plan(m)
    assert plan == pallas_generic.action_plan(jm)
    assert [s for s, _ in plan[0]] == list(m.actions["Iteration"])
    assert not dk3.supports(m, (48, 48, 256), torch.float32)
    for shape in ((48, 48, 256), (3, 5, 7), (64, 64, 64)):
        it, tag = g3.select_engine(m, shape, torch.float32)
        assert tag == f"cuda_generic3d_band[{name},fuse=1]"
        assert it.full_globals
    assert g3.select_engine(m, (8, 8, 8), torch.float64) == (None, None)
    assert g3.select_engine(m, (8, 8, 8), torch.float32,
                            storage_dtype=torch.bfloat16,
                            storage_repr="shifted") == (None, None)
    assert gk.select_engine(m, (8, 8, 8), torch.float32) == (None, None)


def test_kuper_reach_and_passes():
    """d3q19_kuper's Run reads phi over +-1 on each axis and CalcPhi pulls
    the f Run writes: a reach of 2, run as two passes whose earlier stage
    writes f and the last phi (the header's write sets)."""
    m = get_model("d3q19_kuper")
    assert gk.action_plan(m) == ([("BaseIteration", 1), ("CalcPhi", 0)], 2)
    text = _header("d3q19_kuper")
    assert "constexpr int N_STAGES = 2;" in text
    assert "s == 0 ? 0x7ffffu : 0x80000u" in text
    assert gk.DEVICE_MODELS["d3q19_kuper"].plan == tuple(gk.action_plan(m)[0])


# --------------------------------------------------------------------------- #
# the device headers and the bounds
# --------------------------------------------------------------------------- #


def _header(name) -> str:
    """The model's header with the shared headers it includes."""
    path = _cuda_build.CSRC / gk.DEVICE_MODELS[name].header
    return "\n".join(p.read_text() for p in _cuda_build.included(path))


def _enum(text: str, name: str) -> list[str]:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def _table(text: str, fn: str) -> np.ndarray:
    body = re.search(r"constexpr \w+ %s\([^)]*\) \{\s*constexpr \w+ t"
                     r"[^=]*= \{(.*?)\};" % fn, text, re.S).group(1)
    items = re.sub(r"[{}\s]", "", body).split(",")
    return np.array([eval(v) for v in items if v])  # noqa: S307


def c27(a: int, k: int) -> int:
    """csrc/models/d3q27_common.cuh's closed form of the 27-velocity set."""
    return k // 9 - 1 if a == 0 else ((k // 3) % 3 - 1 if a == 1
                                      else k % 3 - 1)


@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_device_header_matches_registry(name):
    """Each header's enums list DEVICE_MODELS' names (which check_layout
    holds against the model), its plane count and streaming vectors are
    the model's, and its shared tables (d3q19_common.cuh, the closed forms
    of d3q27_common.cuh, d3q19_heat's d3q7) are the model's lattice."""
    from tclb_tpu_torch.models.family import mirror_perm
    dm = gk.DEVICE_MODELS[name]
    text = _header(name)
    m = get_model(name)
    gk.check_layout(m)
    assert dm.ndim == 3 and not dm.adjoint
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    n = int(re.search(r"constexpr int N_STORAGE = (\d+);", text).group(1))
    assert n == m.n_storage
    if name.startswith("d3q19"):
        c19 = _table(text, "c19").reshape(3, 19)
        np.testing.assert_array_equal(c19.T, d3q19.E)
        np.testing.assert_allclose(_table(text, "wd"), d3q19.W, rtol=1e-15)
        np.testing.assert_array_equal(_table(text, "opp"), d3q19.OPP)
        np.testing.assert_array_equal(_table(text, "mirror_y"),
                                      mirror_perm(d3q19.E, 1))
        np.testing.assert_array_equal(m.ei[:19], d3q19.E)
    else:
        E = cumulant.velocity_set(3)
        np.testing.assert_array_equal(
            [[c27(a, k) for a in range(3)] for k in range(27)], E)
        np.testing.assert_array_equal(m.ei[:27], E)
        np.testing.assert_array_equal([26 - k for k in range(27)],
                                      lbm.opposite(E))
        np.testing.assert_array_equal(
            [k + 6 - 6 * ((k // 3) % 3) for k in range(27)],
            mirror_perm(E, 1))
        np.testing.assert_array_equal(
            [k + 2 - 2 * (k % 3) for k in range(27)], mirror_perm(E, 2))
        assert "a == 0 ? k / 9 - 1 : (a == 1 ? (k / 3) % 3 - 1 : k % 3 - 1)" \
            in text
        assert "k + 6 - 6 * ((k / 3) % 3)" in text
        assert "k + 2 - 2 * (k % 3)" in text
    if name == "d3q19_heat":
        from tclb_tpu_torch.models import d3q19_heat
        for fn, col in (("ex", 0), ("ey", 1), ("ez", 2)):
            np.testing.assert_array_equal(_table(text, fn), m.ei[:, col])
        np.testing.assert_allclose(_table(text, "wt"), d3q19_heat.WT,
                                   rtol=1e-15)
        np.testing.assert_array_equal(_table(text, "oppt"), d3q19_heat.OPPT)
    # the write mask covers the planes the stages write
    if m.n_storage > 32:
        assert "unsigned long long stage_writes" in text


@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_bound_counts(name):
    """Bytes of one step as chip_smoke.py reports them (every plane read
    and written once, the int32 flags, the zone table) and the operations
    by node kind, positive and by stage."""
    m = get_model(name)
    per_node = {"d3q19_heat": 212, "d3q27": 220, "d3q27_viscoplastic": 236,
                "d3q27_cumulant_qibb_small": 428, "d3q19_kuper": 164}[name]
    shape = (48, 48, 256)
    zonal = len(m.zonal_settings) * m.zone_max * 4
    assert gk.launch_bytes(m, shape) == per_node * 48 * 48 * 256 + zonal
    a, b = lattice_pair(name, "f32")
    flags = b.flags_numpy()
    stages = g3.stage_flops(m, flags, b.state.fields)
    assert len(stages) == len(m.actions["Iteration"])
    assert all(s > 0 for s in stages)
    assert g3.node_step_flops(m, flags, b.state.fields) == sum(stages)
    # bound by bytes at bench.py's shape, even at 1,500 flop a node
    n = 48 * 48 * 256
    assert 1500 * n / 67e12 < gk.launch_bytes(m, shape) / 3.35e12
    if name == "d3q27_cumulant_qibb_small":
        # each cut link of a QIBB node blends (8)
        without = g3.node_step_flops(m, flags)
        q0 = m.storage_index["q[1]"]
        t = m.node_types["QIBB"]
        qibb = (flags.astype(np.int64) & t.mask) == t.value
        cuts = int(((b.state.fields[q0:].numpy() >= 0) & qibb[None]).sum())
        assert cuts and g3.node_step_flops(m, flags, b.state.fields) \
            == without + 8 * cuts


def test_rich_states_paint_every_header_type():
    """The rich painter puts down every node type each header reads, two
    zones, qibb's cuts and a finite state."""
    for name in GENERIC3D_MODELS:
        _, b = lattice_pair(name, "f32")
        m = b.model
        flags = b.flags_numpy()
        assert all(gk.count_types(m, flags, t) for t in _types(name)), name
        assert int((flags >> m.zone_shift).max()) == 1
        assert bool(torch.isfinite(b.state.fields).all())
        if "q" in m.groups:
            q0 = m.storage_index["q[1]"]
            assert (b.state.fields[q0:] >= 0).any()
