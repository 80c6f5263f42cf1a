"""The multi-stage 2D models of the port (``d2q9_pf_pressureEvolution``,
``d2q9_pp_MCMP``, ``d2q9_lee``, ``d2q9_poison_boltzmann``) against the JAX
package, on the CPU.

For each model: the registry, the stage plan (and ``supports()`` on it),
Init and the eager step against the JAX package's XLA engine at f64 (RTOL
1e-10 / ATOL 1e-12, every quantity) and at f32 (tests/test_fastpath.py's
tolerances), a JAX state carried over, the device header's enums against
``DEVICE_MODELS``, the bound counts, the engine choice and the storage
ladder's shifts; for a two-stage plan with a ring of two and a
three-stage plan, the plain versions of the generic kernels against
``pallas_generic`` in interpret mode; MCMP on the painting of
tests/test_pallas_generic.py in both packages.  The kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
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
from tclb_tpu_torch.convert import state_from_numpy  # noqa: E402
from tclb_tpu_torch.core import shift as ddf  # noqa: E402
from tclb_tpu_torch.core.lattice import NodeCtx, Streaming  # noqa: E402
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from tclb_tpu_torch.core.registry import ModelDef  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (MULTISTAGE_MODELS, MULTISTAGE_SETTINGS,  # noqa: E402
                         MULTISTAGE_SHAPE, RICH_MULTISTAGE_SETTINGS,
                         RICH_MULTISTAGE_ZONE1, paint_generic,
                         paint_rich_multistage, rich_flags_multistage)

# One PyTorch intra-op thread per process, as tests/test_torch_onestage.py
# keeps it (pytest-xdist's workers would oversubscribe the cores).
torch.set_num_threads(1)

F64_TOL = dict(rtol=1e-10, atol=1e-12)
# f32 engines against each other: tests/test_fastpath.py's tolerances
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
NITER = 3
# the reference's plans ([(stage, out_ext)], reach)
PLANS = {
    "d2q9_pf_pressureEvolution": ([("BaseIter", 2), ("calcPhase", 0)], 4),
    "d2q9_pp_MCMP": ([("BaseIteration", 2), ("CalcPsi_f", 1),
                      ("CalcPsi_g", 0)], 3),
    "d2q9_lee": ([("BaseIteration", 4), ("CalcRho", 2), ("CalcNu", 0)], 6),
    "d2q9_poison_boltzmann": ([("BaseIteration", 2), ("CalcPsi", 1),
                               ("CalcSubiter", 0)], 3),
}


@functools.lru_cache(maxsize=None)
def _jax_lattice(name, prec, seed=3):
    """The rich state in the JAX package (built once per model, precision
    and seed; the engines below copy its state)."""
    lat = JaxLattice(jax_model(name), MULTISTAGE_SHAPE,
                     dtype=DTYPES[prec][0],
                     settings=RICH_MULTISTAGE_SETTINGS[name])
    return paint_rich_multistage(lat, seed)


def lattice_pair(name, prec="f32", seed=3):
    """The same rich state in both packages (the port's made anew)."""
    b = Lattice(get_model(name), MULTISTAGE_SHAPE, dtype=DTYPES[prec][1],
                settings=RICH_MULTISTAGE_SETTINGS[name], device="cpu")
    return _jax_lattice(name, prec, seed), paint_rich_multistage(b, seed)


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
# registry, plan, Init, eager step, state
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
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
    assert {k: (s.main, s.load_densities) for k, s in got.stages.items()} \
        == {k: (s.main, s.load_densities) for k, s in want.stages.items()}
    assert got.fingerprint == want.fingerprint


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_action_plan_matches_reference(name):
    """The port's plan is the reference's, ``supports()`` takes it, and the
    device header's plan (DEVICE_MODELS) is that plan."""
    m, jm = get_model(name), jax_model(name)
    plan = pallas_generic.action_plan(jm)
    assert gk.action_plan(m) == plan == PLANS[name]
    assert gk.supports(m, (1024, 1024), torch.float32)
    assert pallas_generic.supports(jm, (16, 128), jnp.float32)
    gk.check_layout(m)


def _reach_model(stages: int):
    """A d2q9 model whose ``stages`` streaming stages each read a Field over
    +-4: its Iteration reaches 4 per stage."""
    from tclb_tpu_torch.models.d2q9 import E
    d = ModelDef("reach_probe", ndim=2)
    d.add_densities("f", E)
    d.add_field("phi", dx=(-4, 4), dy=(-4, 4))
    names = [f"S{i}" for i in range(stages)]
    for s in names:
        d.add_stage(s, s)
    d.add_action("Iteration", tuple(names))
    return d.finalize()


@pytest.mark.parametrize("stages,reach,taken", [(2, 8, True), (3, 12, False)])
def test_supports_bounds_the_reach(monkeypatch, stages, reach, taken):
    """``supports()`` takes any plan of reach 8 or less (the reference's
    halo) and rejects a wider one, whatever the model's header."""
    m = _reach_model(stages)
    monkeypatch.setitem(gk.DEVICE_MODELS, m.name,
                        gk.DEVICE_MODELS["d2q9_lee"])
    assert gk.action_plan(m)[1] == reach
    assert gk.supports(m, (64, 64), torch.float32) is taken


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_init_matches_reference(name):
    """Init (every stage of each model's Init action, the Fields'
    stencils on the rich flags, two zones) against the JAX package at f64,
    the Init globals included."""
    m, jm = get_model(name), jax_model(name)
    flags = rich_flags_multistage(m, *MULTISTAGE_SHAPE)
    lats = []
    for lat in (JaxLattice(jm, MULTISTAGE_SHAPE, dtype=jnp.float64,
                           settings=RICH_MULTISTAGE_SETTINGS[name]),
                Lattice(m, MULTISTAGE_SHAPE, dtype=torch.float64,
                        settings=RICH_MULTISTAGE_SETTINGS[name],
                        device="cpu")):
        lat.set_flags(flags)
        for z in m.zonal_settings:
            lat.set_setting(z, RICH_MULTISTAGE_ZONE1[z], zone=1)
        lat.init()
        lats.append(lat)
    a, b = lats
    assert np.isfinite(b.fields_raw()).all()
    np.testing.assert_allclose(b.fields_raw(), np.asarray(a.state.fields),
                               **F64_TOL)
    np.testing.assert_allclose(b.state.globals_.numpy(),
                               np.asarray(a.state.globals_), **F64_TOL)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_eager_step_matches_reference(name, prec):
    """NITER eager steps on the rich state (every node type the header
    reads, two zones) against the JAX package's XLA engine, globals
    included: at f64 to RTOL 1e-10 / ATOL 1e-12 with every quantity, at
    f32 to tests/test_fastpath.py's tolerances."""
    a, b = lattice_pair(name, prec)
    np.testing.assert_array_equal(
        b.fields_raw(), np.asarray(a.state.fields, np.float64))
    want = jax_make_iterate(a.model)(_copy(a.state), a.params, NITER)
    got = make_iterate(b.model)(b.state, b.params, NITER)
    assert bool(torch.isfinite(got.fields).all())
    if prec == "f32":
        _assert_state(got, want)
        return
    _assert_state(got, want, F64_TOL, F64_TOL)
    for q in b.model.quantities:
        np.testing.assert_allclose(
            b.get_quantity(q.name).numpy(),
            np.asarray(a.get_quantity(q.name)), **F64_TOL, err_msg=q.name)


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_jax_state_carries_over(name):
    """The JAX package's state crosses through ``state_from_numpy`` (f64
    and f32) and steps as the JAX package steps it."""
    for prec in ("f64", "f32"):
        a = _jax_lattice(name, prec)
        m = get_model(name)
        state, params = state_from_numpy(
            m, np.asarray(a.state.fields), np.asarray(a.state.flags),
            np.asarray(a.state.globals_), 7, np.asarray(a.params.settings),
            np.asarray(a.params.zone_table), device="cpu")
        assert state.fields.dtype == DTYPES[prec][1]
        want = jax_make_iterate(a.model)(_copy(a.state), a.params, 2)
        got = make_iterate(m)(state, params, 2)
        tol = F64_TOL if prec == "f64" else F32_TOL
        np.testing.assert_allclose(got.fields.numpy(),
                                   np.asarray(want.fields), **tol)
        assert got.iteration == 9


# --------------------------------------------------------------------------- #
# the plain versions of the kernels against pallas_generic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["d2q9_pf_pressureEvolution", "d2q9_lee"])
def test_plain_engines_match_pallas(name):
    """Two f32 Iterations of the port's plain band engine (a plain launch,
    then the globals launch) and its resident engine against the JAX
    package's generic band engine in interpret mode (the fields: at an nx
    that is no multiple of 128 the reference sums no globals in-kernel)
    and its XLA engine (fields and globals): the two-stage plan with a
    ring of two (pressureEvolution, one launch a step) and a three-stage
    plan reaching 6 (lee, one launch a stage)."""
    a, b = lattice_pair(name)
    present = jax_present(a.model, a._host_flags)
    pallas = pallas_generic.make_pallas_iterate(
        a.model, MULTISTAGE_SHAPE, jnp.float32, interpret=True,
        present=present)(_copy(a.state), a.params, 2)
    xla = jax_make_iterate(a.model)(_copy(a.state), a.params, 2)
    band = gk.make_band_iterate(b.model, MULTISTAGE_SHAPE)
    res = gk.make_resident_iterate(b.model, MULTISTAGE_SHAPE)
    assert band.full_globals and res.full_globals
    for got in (band(b.state, b.params, 2), res(b.state, b.params, 2)):
        np.testing.assert_allclose(got.fields.numpy(),
                                   np.asarray(pallas.fields), **F32_TOL)
        assert got.iteration == int(pallas.iteration)
        _assert_state(got, xla)


# --------------------------------------------------------------------------- #
# the device headers, the bounds, the engines and the storage ladder
# --------------------------------------------------------------------------- #


def _enum(text: str, name: str) -> list[str]:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_device_header_matches_registry(name):
    """Each header's enums list DEVICE_MODELS' names (which check_layout
    holds against the model), its plane count and stage count are the
    model's, and its write sets are the planes each stage stores."""
    dm = gk.DEVICE_MODELS[name]
    text = (_cuda_build.CSRC / dm.header).read_text()
    m = get_model(name)
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    n = int(re.search(r"constexpr int N_STORAGE = (\d+);", text).group(1))
    assert n == m.n_storage
    stages = int(re.search(r"constexpr int N_STAGES = (\d+);",
                           text).group(1))
    assert stages == len(dm.plan) == len(m.actions["Iteration"])
    # each stage's write set: the planes its stage function stores
    env = {k: int(v) for k, v in re.findall(
        r"(\w+) = (\d+)", " ".join(re.findall(r"constexpr int ([^;]*);",
                                               text)))}
    body = re.search(r"stage_writes\(int s\) \{\s*return (.*?);\s*\}",
                     text, re.S).group(1)
    lat = paint_rich_multistage(Lattice(
        m, MULTISTAGE_SHAPE, dtype=torch.float64,
        settings=RICH_MULTISTAGE_SETTINGS[name], device="cpu"), 3)
    st = Streaming(m)
    raw = lat.state.fields
    for s, stage in enumerate(m.actions["Iteration"]):
        ctx = NodeCtx(m, st.pull(raw), raw, lat.state.flags, lat.params)
        planes = set()
        for key in m.stage_fns[m.stages[stage].main](ctx):
            planes |= set(m.groups[key]) if key in m.groups \
                else {m.storage_index[key]}
        assert _c_eval(body, {**env, "s": s}) == sum(1 << k for k in planes)


def _c_eval(expr: str, env: dict) -> int:
    """A C integer expression of ``?:``, ``==``, ``<<`` and unsigned
    literals over the names in ``env``."""
    expr = expr.strip()
    depth, q = 0, -1
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "?" and depth == 0:
            q = i
            break
    if q < 0:
        if expr.startswith("(") and expr.endswith(")"):
            return _c_eval(expr[1:-1], env)
        py = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)u\b", r"\1", expr)
        return int(eval(py, {}, dict(env)))  # noqa: S307
    depth = 0
    for j in range(q + 1, len(expr)):
        depth += expr[j] == "("
        depth -= expr[j] == ")"
        if expr[j] == ":" and depth == 0:
            break
    cond, a, b = expr[:q], expr[q + 1:j], expr[j + 1:]
    return _c_eval(a, env) if _c_eval(cond, env) else _c_eval(b, env)


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_bound_counts(name):
    """Bytes of one step as the card must move it (every plane read and
    written once, the int32 flags, the zone table; whatever the launches),
    and the operations by node kind (the counting functions'
    docstrings)."""
    m = get_model(name)
    per_node = {"d2q9_pf_pressureEvolution": 156, "d2q9_pp_MCMP": 164,
                "d2q9_lee": 92, "d2q9_poison_boltzmann": 92}[name]
    zonal = len(m.zonal_settings) * m.zone_max * 4
    assert gk.launch_bytes(m, (1024, 1024)) == per_node * 1024 ** 2 + zonal
    assert gk.launch_bytes(m, (1024, 1024), itemsize=2) == \
        (per_node - 4) // 2 * 1024 ** 2 + 4 * 1024 ** 2 + zonal
    flags = rich_flags_multistage(m, *MULTISTAGE_SHAPE)
    n = flags.size
    coll = gk.count_group(m, flags, "COLLISION")

    def count(*names):
        return gk.count_types(m, flags, *[n for n in names
                                           if n in m.node_types])

    eq = 53
    assert gk._eq_flops() == eq
    assert count("Wall") and coll
    want = {
        # M_CLASSIC and its inverse: 173
        "d2q9_pf_pressureEvolution": (441 + eq + 173) * count("MRT")
        + 8 * n,
        "d2q9_pp_MCMP": (121 + 2 * (eq + 27)) * coll
        + 40 * count("WVelocity", "WPressure", "EVelocity", "EPressure")
        + 16 * n,
        # the d2q9 basis 64, its inverse 109
        "d2q9_lee": (329 + eq + 144) * count("BGK")
        + (329 + eq + 126 + 64 + 173) * count("MRT")
        + 96 * count("ForcedMovingWall")
        + 22 * count("WPressure", "EPressure", "EVelocity")
        + 15 * count("MovingWall") + eq * count("WVelocity") + 58 * n,
        "d2q9_poison_boltzmann": 83 * coll + 9 * count("Wall", "Solid")
        + 10 * n,
    }[name]
    assert gk.node_step_flops(m, flags) == want
    if name != "d2q9_pf_pressureEvolution":
        # one launch a stage: the later stages' share by stage
        stages = gk.stage_flops(m, flags)
        assert len(stages) == len(PLANS[name][0]) and sum(stages) == want
        assert stages[1:] == {"d2q9_pp_MCMP": (8 * n, 8 * n),
                              "d2q9_lee": (8 * n, 50 * n),
                              "d2q9_poison_boltzmann": (9 * n, n)}[name]


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_stage_plan_and_engine_choice(name):
    """The resident engine where the lattice fits half the L2 (every
    example's lattice and poison_boltzmann's 128x128), the band engine at
    1024x1024, nothing at f64; bf16 on both, named in the tag."""
    m = get_model(name)
    for shape in ((64, 128), (128, 64), (128, 128)):
        assert gk.select_engine(m, shape, torch.float32)[1] == \
            f"cuda_generic_resident[{name},fuse=N]"
    it, tag = gk.select_engine(m, (1024, 1024), torch.float32)
    assert tag == f"cuda_generic_band[{name},fuse=1]" and it.full_globals
    assert gk.select_engine(m, (64, 32), torch.float64) == (None, None)
    assert gk.select_engine(m, (1024, 1024), torch.float32,
                            storage_dtype=torch.bfloat16,
                            storage_repr="shifted")[1] == \
        f"cuda_generic_band[{name},fuse=1,bfloat16/shifted]"


@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_storage_shifts_match_reference(name):
    """Each plane's DDF shift as the reference derives it (w_i on the d2q9
    groups, the Poisson weights on poison_boltzmann's g, 0 on the Fields
    and subiter)."""
    pm, jm = get_model(name), jax_model(name)
    np.testing.assert_array_equal(ddf.storage_shift(pm),
                                  jax_shift.storage_shift(jm))
    assert ddf.kernel_shift(pm, "shifted") == tuple(
        float(w) for w in jax_shift.storage_shift(jm).astype(np.float32))
    assert ddf.default_repr(pm, True) == jax_shift.default_repr(jm, True)


@pytest.mark.parametrize("name", ["d2q9_pp_MCMP", "d2q9_lee"])
def test_narrowed_step_matches_reference(name):
    """bf16 shifted storage: the port's narrowed eager engine against the
    JAX package's XLA engine at f64 compute, the same bf16 values after two
    steps (three stages, one narrowing a step)."""
    pm, jm = get_model(name), jax_model(name)
    a = paint_rich_multistage(JaxLattice(
        jm, MULTISTAGE_SHAPE, dtype=jnp.float64,
        settings=RICH_MULTISTAGE_SETTINGS[name], storage_dtype=jnp.bfloat16),
        seed=4)
    b = paint_rich_multistage(Lattice(
        pm, MULTISTAGE_SHAPE, dtype=torch.float64,
        settings=RICH_MULTISTAGE_SETTINGS[name], device="cpu",
        storage_dtype=torch.bfloat16), seed=4)
    assert b.engine_name == "eager[bfloat16/shifted]"
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.fields_raw(), np.float64))
    a.iterate(2)
    b.iterate(2)
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.fields_raw(), np.float64))


@pytest.mark.parametrize("painting,steps,finite", [
    ("both_faces", 400, False), ("rich_zone1", 100, False),
    ("no_e_face", 400, True)])
def test_mcmp_painted_lattice_on_both_packages(painting, steps, finite):
    """MCMP on tests/test_pallas_generic.py's painting (paint_generic: W
    velocity and E pressure faces, a zone 1 stripe) at 64x64, f64, in the
    JAX package's XLA engine and the port's eager engine: with both faces
    (the two columns meet across the periodic edge) both go non-finite
    within 400 steps, with the rich zone 1 values as well within 100;
    without the E face, as chip_smoke.py's 1024x1024 lattice is painted,
    both stay finite.  The two agree to 1e-9 after half the steps, so
    the blow-up is the physics of the painting, not the port's."""
    name, shape = "d2q9_pp_MCMP", (64, 64)
    lats = []
    for lat, m in ((JaxLattice(jax_model(name), shape, dtype=jnp.float64,
                               settings=MULTISTAGE_SETTINGS[name]),
                    jax_model(name)),
                   (Lattice(get_model(name), shape, dtype=torch.float64,
                            settings=MULTISTAGE_SETTINGS[name],
                            device="cpu"), get_model(name))):
        flags = paint_generic(m, *shape)
        if painting == "no_e_face":
            flags[1:-1, -1] = m.flag_for("BGK")
        lat.set_flags(flags)
        if painting == "rich_zone1":
            for z in m.zonal_settings:
                lat.set_setting(z, RICH_MULTISTAGE_ZONE1[z], zone=1)
        lat.init()
        lats.append(lat)
    a, b = lats
    for lat in lats:
        lat.iterate(steps // 2)
    if painting != "rich_zone1":
        np.testing.assert_allclose(b.fields_raw(),
                                   np.asarray(a.state.fields), rtol=0,
                                   atol=1e-9)
    for lat in lats:
        lat.iterate(steps - steps // 2)
    assert bool(np.isfinite(np.asarray(a.state.fields)).all()) is finite
    assert bool(np.isfinite(b.fields_raw()).all()) is finite
