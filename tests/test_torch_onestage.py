"""The one-stage 2D models of the port (``d2q9_heat``,
``d2q9_heat_conjugate``, ``d2q9_hb``, ``sw``, ``d2q9_solid``,
``d2q9_npe_guo``) against the JAX package, on the CPU: what every model
shares.

For each model: the registry, the eager step against the JAX package's XLA
step at f64 (RTOL 1e-10 / ATOL 1e-12) with every quantity, the device
header's enums against ``DEVICE_MODELS``, the bound counts, the stage plan
and the engine choice, a JAX state carried over, and the storage ladder's
shifts and narrowed step against the JAX package's.  ``check_plain_engines``
(the plain band and resident engines of the generic kernels in f32 against
``pallas_generic`` in interpret mode and the XLA engine) runs from the
model files, with the small mirrors of the reference's physics tests:
``tests/test_torch_heat_family.py``, ``test_torch_sw.py``,
``test_torch_solid.py`` and ``test_torch_npe_guo.py``, one file each so
that pytest-xdist spreads them.  The kernels themselves are held against
the plain versions on the card by ``tests/test_torch_cuda.py``.
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

from tclb_tpu.core import shift as jax_shift  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_iterate as jax_make_iterate  # noqa: E402,E501
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_generic  # noqa: E402
from tclb_tpu.ops.lbm import present_types as jax_present  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.core import shift as ddf  # noqa: E402
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (MULTISTAGE_SETTINGS, ONESTAGE_MODELS,  # noqa: E402
                         ONESTAGE_SHAPE, RICH_ONESTAGE_SETTINGS,
                         paint_generic, paint_rich_onestage,
                         rich_flags_onestage)

# One PyTorch intra-op thread per process: pytest-xdist imports every test
# file into each of its workers, so this holds for the whole run.  At the
# default of a thread per core, six workers oversubscribe the cores and
# OpenMP's waits stall the many small eager operations (the channel3d
# golden of test_torch_control.py: 4 s alone, 539 s beside five busy
# workers; with one thread 4.5 s alone).
torch.set_num_threads(1)

F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py's tolerances
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
NITER = 3


@functools.lru_cache(maxsize=None)
def _jax_lattice(name, prec, seed=3):
    """The rich state in the JAX package (built once per model, precision
    and seed; the engines below copy its state)."""
    lat = JaxLattice(jax_model(name), ONESTAGE_SHAPE, dtype=DTYPES[prec][0],
                     settings=RICH_ONESTAGE_SETTINGS[name])
    return paint_rich_onestage(lat, seed)


def lattice_pair(name, prec="f32", seed=3):
    """The same rich state in both packages (the port's made anew)."""
    b = Lattice(get_model(name), ONESTAGE_SHAPE, dtype=DTYPES[prec][1],
                settings=RICH_ONESTAGE_SETTINGS[name], device="cpu")
    return _jax_lattice(name, prec, seed), paint_rich_onestage(b, seed)


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
# registry, eager step, state
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_registry_matches_reference(name):
    got, want = get_model(name), jax_model(name)
    assert got.storage_names == want.storage_names
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    assert {n: (t.value, t.mask) for n, t in got.node_types.items()} == \
        {n: (t.value, t.mask) for n, t in want.node_types.items()}
    assert [(g.name, g.op) for g in got.globals_] == \
        [(g.name, g.op) for g in want.globals_]
    assert [(q.name, q.vector, q.adjoint) for q in got.quantities] == \
        [(q.name, q.vector, q.adjoint) for q in want.quantities]
    assert [(f.name, f.dx_range, f.dy_range) for f in got.fields] == \
        [(f.name, f.dx_range, f.dy_range) for f in want.fields]
    assert got.actions == want.actions
    assert got.fingerprint == want.fingerprint


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_eager_step_matches_reference(name):
    """NITER eager steps in f64 on the rich state (every node type the
    model reads, two zones) against the JAX package's XLA engine, globals
    included; then every quantity.  The f32 eager step is held against
    the XLA engine in ``test_plain_engines_match_pallas`` (the plain band
    engine is that step)."""
    a, b = lattice_pair(name, "f64")
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.state.fields, np.float64))
    want = jax_make_iterate(a.model)(_copy(a.state), a.params, NITER)
    got = make_iterate(b.model)(b.state, b.params, NITER)
    _assert_state(got, want, F64_TOL, F64_TOL)
    for q in b.model.quantities:
        np.testing.assert_allclose(
            b.get_quantity(q.name).numpy(),
            np.asarray(a.get_quantity(q.name)), **F64_TOL, err_msg=q.name)


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_jax_state_carries_over(name, tmp_path):
    """The JAX package's state of each model crosses with no model-specific
    code: ``state_from_numpy`` / ``state_to_numpy`` in f64 and f32 and as
    bf16 bits, and ``Lattice.load`` of a JAX ``.npz``."""
    a, _ = lattice_pair(name, "f64")
    m = get_model(name)
    table = np.asarray(a.params.zone_table)
    for dt in (np.float64, np.float32):
        fields = np.asarray(a.state.fields).astype(dt)
        state, params = state_from_numpy(
            m, fields, np.asarray(a.state.flags), np.asarray(a.state.globals_),
            3, np.asarray(a.params.settings), table, device="cpu")
        back = state_to_numpy(state, params)
        np.testing.assert_array_equal(back["fields"], fields)
        np.testing.assert_array_equal(back["flags"], np.asarray(a.state.flags))
    bits = np.asarray(jnp.asarray(a.state.fields, jnp.bfloat16)).view(
        np.uint16)
    state, _ = state_from_numpy(m, bits, np.asarray(a.state.flags),
                                np.asarray(a.state.globals_), 0,
                                np.asarray(a.params.settings), table,
                                device="cpu", storage_dtype=torch.bfloat16)
    assert state.fields.dtype == torch.bfloat16
    np.testing.assert_array_equal(state.fields.view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    a.save(str(tmp_path / "s"))
    b = Lattice(m, ONESTAGE_SHAPE, dtype=torch.float64, device="cpu")
    b.load(str(tmp_path / "s"))
    np.testing.assert_array_equal(b.state.fields.numpy(),
                                  np.asarray(a.state.fields))
    np.testing.assert_array_equal(b.flags_numpy(), np.asarray(a.state.flags))


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_storage_shifts_match_reference(name):
    """Each plane's DDF shift (w_i on a group whose velocity set the
    reference recognizes, the Poisson groups of d2q9_npe_guo included; 0
    on w, fi_s and Cs) as the reference derives it."""
    pm, jm = get_model(name), jax_model(name)
    np.testing.assert_array_equal(ddf.storage_shift(pm),
                                  jax_shift.storage_shift(jm))
    assert ddf.kernel_shift(pm, "shifted") == tuple(
        float(w) for w in jax_shift.storage_shift(jm).astype(np.float32))
    assert ddf.default_repr(pm, True) == jax_shift.default_repr(jm, True)


@pytest.mark.parametrize("name", ["d2q9_solid", "d2q9_npe_guo"])
def test_narrowed_step_matches_reference(name):
    """bf16 shifted storage: the port's narrowed eager engine against the
    JAX package's XLA engine at f64 compute, the same bf16 values after
    two steps (the models with Field planes and with five groups)."""
    pm, jm = get_model(name), jax_model(name)
    a = paint_rich_onestage(JaxLattice(
        jm, ONESTAGE_SHAPE, dtype=jnp.float64,
        settings=RICH_ONESTAGE_SETTINGS[name], storage_dtype=jnp.bfloat16),
        seed=4)
    b = paint_rich_onestage(Lattice(
        pm, ONESTAGE_SHAPE, dtype=torch.float64,
        settings=RICH_ONESTAGE_SETTINGS[name], device="cpu",
        storage_dtype=torch.bfloat16), seed=4)
    assert b.engine_name == "eager[bfloat16/shifted]"
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.fields_raw(), np.float64))
    a.iterate(2)
    b.iterate(2)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.fields_raw(), np.float64))


# --------------------------------------------------------------------------- #
# the engines; the plain versions of the kernels against pallas_generic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_stage_plan_and_engine_choice(name):
    """One stage of reach 1, as the reference plans it; the resident
    engine where the two stacks fit half the L2 (every example's lattice),
    the band engine at 1024x1024, nothing at f64; bf16 on both, named in
    the tag."""
    m, jm = get_model(name), jax_model(name)
    assert gk.action_plan(m) == pallas_generic.action_plan(jm) \
        == ([("BaseIteration", 0)], 1)
    gk.check_layout(m)
    for shape in ((64, 32), (128, 128), (64, 512)):
        assert gk.select_engine(m, shape, torch.float32)[1] == \
            f"cuda_generic_resident[{name},fuse=N]"
    it, tag = gk.select_engine(m, (1024, 1024), torch.float32)
    assert tag == f"cuda_generic_band[{name},fuse=1]" and it.full_globals
    assert gk.select_engine(m, (64, 32), torch.float64) == (None, None)
    assert gk.select_engine(m, (1024, 1024), torch.float32,
                            storage_dtype=torch.bfloat16,
                            storage_repr="shifted")[1] == \
        f"cuda_generic_band[{name},fuse=1,bfloat16/shifted]"


def check_plain_engines(name):
    """NITER f32 Iterations of the port's plain band engine (plain
    launches, then the globals launch) and its resident engine (one
    2-step launch, then the band engine) against the JAX package's generic
    band engine in interpret mode and its XLA engine, fields and the last
    step's globals; for d2q9_heat also against the reference's resident
    engine (the other models' reference resident engines compose the same
    way)."""
    a, b = lattice_pair(name)
    present = jax_present(a.model, a._host_flags)
    want = pallas_generic.make_pallas_iterate(
        a.model, ONESTAGE_SHAPE, jnp.float32, interpret=True,
        present=present)(_copy(a.state), a.params, NITER)
    band = gk.make_band_iterate(b.model, ONESTAGE_SHAPE)
    res = gk.make_resident_iterate(b.model, ONESTAGE_SHAPE)
    assert band.full_globals and res.full_globals
    got = band(b.state, b.params, NITER)
    _assert_state(got, want)
    _assert_state(got, jax_make_iterate(a.model)(_copy(a.state), a.params,
                                                 NITER))
    _assert_state(res(b.state, b.params, NITER), want)
    if name == "d2q9_heat":
        jit = pallas_generic.make_resident_iterate(
            a.model, ONESTAGE_SHAPE, jnp.float32, interpret=True,
            present=present)
        _assert_state(res(b.state, b.params, NITER),
                      jit(_copy(a.state), a.params, NITER))


# --------------------------------------------------------------------------- #
# the device headers and the bounds
# --------------------------------------------------------------------------- #


def _enum(text: str, name: str) -> list[str]:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_device_header_matches_registry(name):
    """Each header's enums list DEVICE_MODELS' names (which check_layout
    holds against the model), its plane count is the model's, and the
    shared d2q9 tables are the model's lattice."""
    from tclb_tpu_torch.models import d2q9
    dm = gk.DEVICE_MODELS[name]
    text = (_cuda_build.CSRC / dm.header).read_text()
    m = get_model(name)
    gk.check_layout(m)
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    n = int(re.search(r"constexpr int N_STORAGE = (\d+);", text).group(1))
    assert n == m.n_storage
    common = (_cuda_build.CSRC / "models" / "d2q9_common.cuh").read_text()

    def table(fn):
        body = re.search(r"constexpr \w+ %s\([^)]*\) \{\s*constexpr \w+ t"
                         r"[^=]*= \{(.*?)\};" % fn, common, re.S).group(1)
        items = re.sub(r"[{}\s]", "", body).split(",")
        return np.array([eval(v) for v in items if v])  # noqa: S307

    np.testing.assert_array_equal(table("vx"), d2q9.E[:, 0])
    np.testing.assert_array_equal(table("vy"), d2q9.E[:, 1])
    np.testing.assert_allclose(table("wd"), d2q9.W, rtol=1e-15)
    np.testing.assert_array_equal(table("opp"), d2q9.OPP)
    np.testing.assert_array_equal(table("basis").reshape(9, 9), d2q9.M)
    # every d2q9 group of the model streams along the shared velocity set
    assert np.all(m.ei[:, :2][[i for g in m.groups.values() if len(g) == 9
                               for i in g]]
                  == np.tile(d2q9.E, (sum(len(g) == 9 for g in
                                          m.groups.values()), 1)))


@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_bound_counts(name):
    """Bytes and operations of one launch, as chip_smoke.py reports them:
    every plane read and written (146 B a node for the heat models is 148
    with int32 flags), the zone table; the operations by node kind (see
    the counting functions' docstrings)."""
    m = get_model(name)
    per_node = {"d2q9_heat": 148, "d2q9_heat_conjugate": 148,
                "d2q9_hb": 148, "sw": 84, "d2q9_solid": 236,
                "d2q9_npe_guo": 364}[name]
    zonal = len(m.zonal_settings) * m.zone_max * 4
    assert gk.launch_bytes(m, (1024, 1024)) == per_node * 1024 ** 2 + zonal
    assert gk.launch_bytes(m, (1024, 1024), itemsize=2) == \
        (per_node - 4) // 2 * 1024 ** 2 + 4 * 1024 ** 2 + zonal
    flags = rich_flags_onestage(m, *ONESTAGE_SHAPE)
    n = flags.size
    coll = gk.count_group(m, flags, "COLLISION")

    def count(*names):
        return gk.count_types(m, flags, *[n for n in names
                                           if n in m.node_types])

    faces = count("WVelocity", "WPressure", "EVelocity", "EPressure")
    eq = 53            # one d2q9 equilibrium
    assert gk._eq_flops() == eq
    want = {
        "d2q9_heat": 28 * n + (eq + 94) * coll + 22 * faces
        + 9 * count("WVelocity", "EPressure") + count("Outlet"),
        # the moments 64, the inverse basis' rows 109
        "sw": (64 + 48) * n + 7 * count("Obj1") + (31 + 109) * coll
        + 22 * faces,
        "d2q9_solid": 36 * n + (100 + 3 * (2 * eq + 27)) * coll
        + count("ForceTemperature", "ForceConcentration")
        + 42 * count("WVelocity", "WPressure") + 34 * count("EPressure")
        + 22 * count("EVelocity"),
        "d2q9_npe_guo": (72 + 56 + 36 + 64 + 50 + 2 * eq + 324) * coll
        + 37 * count("Wall", "Solid") + 49 * count("WPressure", "EPressure"),
    }
    want["d2q9_heat_conjugate"] = want["d2q9_heat"] + 75 * count("Solid")
    want["d2q9_hb"] = want["d2q9_heat"] + (eq + 72) * count("Destroy")
    assert count("Solid") and count("Outlet") and faces
    assert gk.node_step_flops(m, flags) == want[name]


def test_paint_generic_paints_what_the_cells_need():
    """chip_smoke.py's 1024x1024 lattices use ``paint_generic``: walls, the
    W and E faces, a zone stripe, hb's Destroy and solid's Seed."""
    for name in ONESTAGE_MODELS:
        m = get_model(name)
        flags = paint_generic(m, 64, 64)
        types = {n for n in m.node_types if gk.count_types(m, flags, n)}
        assert {"Wall", "EPressure"} <= types
        assert ("WPressure" if name == "d2q9_npe_guo" else "WVelocity") \
            in types
        assert int((flags >> m.zone_shift).max()) == 1
        assert ("Destroy" in types) == (name == "d2q9_hb")
        assert ("Seed" in types) == (name == "d2q9_solid")


def test_parity_painter_paints_every_header_type():
    """``ops/generic2d_parity.py`` (the template's bit-parity check
    against another copy of ``csrc/``) paints every node type each 2D
    header reads, two zones, and a finite state."""
    from tclb_tpu_torch.ops import generic2d_parity
    for name, dm in gk.DEVICE_MODELS.items():
        if dm.ndim != 2:
            continue
        m = get_model(name)
        # d2q9_pp_MCMP's default Gc = 0 puts Gad/Gc = 0/0 on its walls
        lat = generic2d_parity.paint(m, (37, 53), device="cpu",
                                     settings=MULTISTAGE_SETTINGS.get(name))
        flags = lat.flags_numpy()
        assert all(gk.count_types(m, flags, t) for t in dm.node_types), name
        assert int((flags >> m.zone_shift).max()) == 1
        assert bool(torch.isfinite(lat.state.fields).all())
