"""Checks shared by ``tests/test_torch_models2d_*.py``: the six 2D models
of the phase-field, pseudopotential and design workflows (``wave``,
``wave2d``, ``d2q9_diff``, ``d2q9_pf``, ``d2q9_pp_LBL``,
``d2q9_pf_curvature``) against the JAX package, on the CPU.

Each test file installs the jax 0.9 shim before it imports this module
(which imports the JAX package), then runs these checks on its own
models, so that pytest-xdist spreads the interpret-mode compiles over its
workers.  The kernels themselves are held against these plain versions on
the card by ``chip_smoke.py``.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclb_tpu import adjoint as jax_adjoint
from tclb_tpu.core.lattice import Lattice as JaxLattice
from tclb_tpu.core.lattice import make_action_step as jax_step
from tclb_tpu.core.lattice import make_iterate as jax_make_iterate
from tclb_tpu.models import get_model as jax_model
from tclb_tpu.ops import pallas_generic
from tclb_tpu.ops.lbm import present_types as jax_present
from tclb_tpu_torch import Lattice, get_model
from tclb_tpu_torch.adjoint import (InternalTopology, make_objective_run,
                                    make_unsteady_gradient)
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy
from tclb_tpu_torch.core.lattice import make_iterate
from tclb_tpu_torch.ops import _cuda_build
from tclb_tpu_torch.ops import adjoint_kernels as ak
from tclb_tpu_torch.ops import generic_kernels as gk
from torch_cases import (MODELS2D_SHAPE, RICH_MODELS2D_SETTINGS,
                         RICH_MODELS2D_ZONE1, paint_rich_models2d,
                         rich_flags_models2d)

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
# the reference's plans ([(stage, out_ext)], reach) and the port's form
PLANS = {"wave": ([("BaseIteration", 0)], 1),
         "wave2d": ([("BaseIteration", 0)], 1),
         "d2q9_diff": ([("BaseIteration", 0)], 1),
         "d2q9_pf": ([("BaseIteration", 0)], 1),
         "d2q9_pp_LBL": ([("BaseIteration", 1), ("calcPsi", 0)], 2),
         "d2q9_pf_curvature": ([("BaseIteration", 1), ("CalcPhi", 0)], 2)}
FORMS = {"wave": "pass", "wave2d": "pass", "d2q9_diff": "pass",
         "d2q9_pf": "pass", "d2q9_pp_LBL": "ring",
         "d2q9_pf_curvature": "ring"}
# bytes a node of one launch moves in f32: every plane read and written
# and the int32 flags
NODE_BYTES = {"wave": 20, "wave2d": 60, "d2q9_diff": 84, "d2q9_pf": 148,
              "d2q9_pp_LBL": 84, "d2q9_pf_curvature": 156}


@functools.lru_cache(maxsize=None)
def _jax_lattice(name, prec, seed=3):
    """The rich state in the JAX package (built once per model, precision
    and seed; the engines below copy its state)."""
    lat = JaxLattice(jax_model(name), MODELS2D_SHAPE, dtype=DTYPES[prec][0],
                     settings=RICH_MODELS2D_SETTINGS[name])
    return paint_rich_models2d(lat, seed)


def lattice_pair(name, prec="f32", seed=3):
    """The same rich state in both packages (the port's made anew)."""
    b = Lattice(get_model(name), MODELS2D_SHAPE, dtype=DTYPES[prec][1],
                settings=RICH_MODELS2D_SETTINGS[name], device="cpu")
    return _jax_lattice(name, prec, seed), paint_rich_models2d(b, seed)


def copy(state):
    # the JAX engines donate their input state
    return jax.tree.map(jnp.copy, state)


def assert_state(got, want, tol=F32_TOL, gtol=GLOBALS_TOL):
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **tol)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **gtol)
    assert got.iteration == int(want.iteration)


def check_registry(name):
    got, want = get_model(name), jax_model(name)
    assert got.storage_names == want.storage_names
    np.testing.assert_array_equal(got.ei, want.ei)
    assert [(s.name, s.default, s.zonal) for s in got.settings] == \
        [(s.name, s.default, s.zonal) for s in want.settings]
    np.testing.assert_array_equal(got.settings_vector(),
                                  want.settings_vector())
    assert {n: (t.value, t.mask) for n, t in got.node_types.items()} == \
        {n: (t.value, t.mask) for n, t in want.node_types.items()}
    assert [(g.name, g.op) for g in got.globals_] == \
        [(g.name, g.op) for g in want.globals_]
    assert [(q.name, q.vector, q.adjoint) for q in got.quantities] == \
        [(q.name, q.vector, q.adjoint) for q in want.quantities]
    assert [(f.name, f.dx_range, f.dy_range, f.parameter)
            for f in got.fields] == \
        [(f.name, f.dx_range, f.dy_range, f.parameter) for f in want.fields]
    assert [d.parameter for d in got.densities] == \
        [d.parameter for d in want.densities]
    assert got.actions == want.actions
    assert got.fingerprint == want.fingerprint


def check_eager_step(name):
    """Init and NITER eager steps in f64 on the rich state (every node
    type the header reads, two zones) against the JAX package's XLA
    engine, globals included; then every quantity."""
    a, b = lattice_pair(name, "f64")
    np.testing.assert_array_equal(b.fields_raw(),
                                  np.asarray(a.state.fields, np.float64))
    want = jax_make_iterate(a.model)(copy(a.state), a.params, NITER)
    got = make_iterate(b.model)(b.state, b.params, NITER)
    assert_state(got, want, F64_TOL, F64_TOL)
    for q in b.model.quantities:
        np.testing.assert_allclose(
            b.get_quantity(q.name).numpy(),
            np.asarray(a.get_quantity(q.name)), **F64_TOL, err_msg=q.name)


def check_init(name):
    """Init alone (the rich flags, zone 1's values, no noise) in f64: the
    same planes as the JAX package's, Fields written by the Init action's
    later stages included."""
    ja = JaxLattice(jax_model(name), MODELS2D_SHAPE, dtype=jnp.float64,
                    settings=RICH_MODELS2D_SETTINGS[name])
    tb = Lattice(get_model(name), MODELS2D_SHAPE, dtype=torch.float64,
                 settings=RICH_MODELS2D_SETTINGS[name], device="cpu")
    for lat in (ja, tb):
        lat.set_flags(rich_flags_models2d(lat.model, *MODELS2D_SHAPE))
        for z in lat.model.zonal_settings:
            lat.set_setting(z, RICH_MODELS2D_ZONE1[z], zone=1)
        lat.init()
    np.testing.assert_allclose(tb.fields_raw(), np.asarray(ja.state.fields),
                               **F64_TOL)


def check_plain_engines(name):
    """NITER f32 Iterations of the port's plain band engine (plain
    launches, then the globals launch) and its resident engine against the
    JAX package's generic band engine in interpret mode and its XLA
    engine, fields and the last step's globals."""
    a, b = lattice_pair(name)
    present = jax_present(a.model, a._host_flags)
    want = pallas_generic.make_pallas_iterate(
        a.model, MODELS2D_SHAPE, jnp.float32, interpret=True,
        present=present)(copy(a.state), a.params, NITER)
    xla = jax_make_iterate(a.model)(copy(a.state), a.params, NITER)
    band = gk.make_band_iterate(b.model, MODELS2D_SHAPE)
    res = gk.make_resident_iterate(b.model, MODELS2D_SHAPE)
    assert band.full_globals and res.full_globals
    for got in (band(b.state, b.params, NITER),
                res(b.state, b.params, NITER)):
        assert_state(got, want)
        assert_state(got, xla)


def check_kernels_plain(name):
    """The kernels' plain versions on CPU tensors against the eager step
    they are: ``step`` and ``step_globals`` one Iteration, ``resident``
    eight, each from the rich state, no launch counted."""
    _, b = lattice_pair(name)
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


def _enum(text: str, name: str) -> list[str]:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def check_device_header(name):
    """The header's enums list DEVICE_MODELS' names (which check_layout
    holds against the model), its plane and stage counts are the
    model's, its write sets are the planes each stage stores, and it
    builds generic2d_step_b exactly where DEVICE_MODELS says so."""
    dm = gk.DEVICE_MODELS[name]
    text = (_cuda_build.CSRC / dm.header).read_text()
    m = get_model(name)
    gk.check_layout(m)
    for enum, prefix, names in (("Setting", "S_", dm.settings),
                                ("NodeType", "T_", dm.node_types),
                                ("Group", "G_", dm.groups),
                                ("Zonal", "Z_", dm.zonal),
                                ("Global", "GL_", dm.globals_)):
        assert _enum(text, enum) == [prefix + s for s in names], enum
    n = int(re.search(r"constexpr int N_STORAGE = (\d+);", text).group(1))
    assert n == m.n_storage
    stages = int(re.search(r"constexpr int N_STAGES = (\d+);",
                           text).group(1))
    assert stages == len(dm.plan) == len(m.actions["Iteration"])
    assert ("#define TCLB_MODEL_ADJOINT 1" in text) == dm.adjoint
    assert ("stage_b<" in text) == dm.adjoint
    # the write sets: the planes each stage of the eager model stores
    writes = re.search(r"stage_writes\(int(?: s)?\) \{\s*return (.*?);",
                       text, re.S).group(1)
    masks = [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", writes)]
    stored = []
    for stage, _ in dm.plan:
        fn = m.stage_fns[m.stages[stage].main]
        out = fn(_probe_ctx(m))
        idx = set()
        for key in out:
            idx |= set(m.groups[key]) if key in m.groups \
                else {m.storage_index[key]}
        stored.append(sum(1 << i for i in idx))
    assert masks == stored


def _probe_ctx(m):
    """A NodeCtx over a small painted f64 state, for reading which planes
    a stage function stores."""
    from tclb_tpu_torch.core.lattice import NodeCtx, Streaming
    lat = paint_rich_models2d(Lattice(m, MODELS2D_SHAPE,
                                      dtype=torch.float64, device="cpu",
                                      settings=RICH_MODELS2D_SETTINGS[m.name]),
                              3)
    f = lat.state.fields
    return NodeCtx(m, Streaming(m).pull(f), f, lat.state.flags, lat.params)


def check_plan_and_engines(name):
    """The reference's plan, the form generic2d_step runs it in, and the
    engines: the resident engine where the two stacks fit half the L2
    (128x128), the band engine where they do not, nothing at f64; bf16
    on both, named in the tag; the kernel adjoint for the two models
    with a reverse stage."""
    m, jm = get_model(name), jax_model(name)
    assert gk.action_plan(m) == pallas_generic.action_plan(jm) \
        == PLANS[name]
    assert gk.step_form(m) == FORMS[name]
    assert gk.supports(m, (128, 128), torch.float32)
    assert gk.select_engine(m, (128, 128), torch.float32)[1] == \
        f"cuda_generic_resident[{name},fuse=N]"
    big = (2048, 2048) if name == "wave" else (1024, 1024)
    it, tag = gk.select_engine(m, big, torch.float32)
    assert tag == f"cuda_generic_band[{name},fuse=1]" and it.full_globals
    assert gk.select_engine(m, (128, 128), torch.float64) == (None, None)
    from tclb_tpu_torch.core import shift as ddf
    rep = "shifted" if ddf.has_shift(m) else "raw"
    assert gk.select_engine(m, big, torch.float32,
                            storage_dtype=torch.bfloat16,
                            storage_repr=rep)[1] == \
        f"cuda_generic_band[{name},fuse=1,bfloat16/{rep}]"
    assert ak.supports_diff(m, (128, 128), torch.float32) == \
        gk.DEVICE_MODELS[name].adjoint
    assert not ak.supports_diff(m, (128, 128), torch.float32,
                                storage_dtype=torch.bfloat16)


def check_bounds(name, flops):
    """Bytes and operations of one launch, as chip_smoke.py reports them:
    every plane read and written and the int32 flags a node, the zone
    table once (bf16: 2 B a plane value); the operations by node kind
    (see the counting functions' docstrings), ``flops(m, count)``."""
    m = get_model(name)
    zonal = len(m.zonal_settings) * m.zone_max * 4
    per = NODE_BYTES[name]
    assert per == 8 * m.n_storage + 4
    assert gk.launch_bytes(m, (1024, 1024)) == per * 1024 ** 2 + zonal
    assert gk.launch_bytes(m, (1024, 1024), itemsize=2) == \
        (4 * m.n_storage + 4) * 1024 ** 2 + zonal
    flags = rich_flags_models2d(m, *MODELS2D_SHAPE)

    def count(*names):
        return sum(gk.count_group(m, flags, n) if n in m.group_masks
                   else gk.count_types(m, flags, n) for n in names)

    assert gk.node_step_flops(m, flags) == flops(m, count, flags.size)
    if gk.DEVICE_MODELS[name].adjoint:
        assert ak.launch_bytes_b(m, (1024, 1024)) == \
            (12 * m.n_storage + 4) * 1024 ** 2
        assert gk.node_step_flops(m, flags) < ak.node_step_b_flops(m, flags)


def check_state_carries_over(name):
    """The JAX package's state crosses with no model-specific code, the
    parameter plane ``w`` of the design models with it:
    ``state_from_numpy`` / ``state_to_numpy`` in f64 and f32, and the
    design vector InternalTopology reads (the parameter planes) is the
    JAX package's."""
    a, b = lattice_pair(name, "f64")
    m = get_model(name)
    table = np.asarray(a.params.zone_table)
    for dt in (np.float64, np.float32):
        fields = np.asarray(a.state.fields).astype(dt)
        state, params = state_from_numpy(
            m, fields, np.asarray(a.state.flags), np.asarray(a.state.globals_),
            3, np.asarray(a.params.settings), table, device="cpu")
        back = state_to_numpy(state, params)
        np.testing.assert_array_equal(back["fields"], fields)
        np.testing.assert_array_equal(
            back["settings"].astype(dt),
            np.asarray(a.params.settings).astype(dt))
    if any(d.parameter for d in m.densities):
        theta = jax_adjoint.InternalTopology(a.model).get(a.state, a.params)
        got = InternalTopology(m).get(b.state, b.params)
        np.testing.assert_array_equal(got.numpy(), np.asarray(theta))
        assert InternalTopology(m).names == ("w",)


# --------------------------------------------------------------------------- #
# the reverse (the two design models)
# --------------------------------------------------------------------------- #


def _jax_vjp(a, lam, lam_g):
    step = jax_step(a.model)

    def fn(fields, sett):
        s = step(a.state.replace(fields=fields),
                 a.params.replace(settings=sett))
        return s.fields, s.globals_

    _, vjp = jax.vjp(fn, a.state.fields, a.params.settings)
    return vjp((jnp.asarray(lam), jnp.asarray(lam_g)))


def check_step_b_plain(name):
    """lam_in and the settings cotangent of one Iteration (``step_b`` on
    CPU tensors: its plain version) against ``jax.vjp`` of the JAX
    package's step at f64 on the rich state."""
    a, b = lattice_pair(name, "f64")
    rng = np.random.default_rng(7)
    lam = rng.standard_normal((b.model.n_storage,) + MODELS2D_SHAPE)
    lam_g = rng.standard_normal(b.model.n_globals)
    want_in, want_s = _jax_vjp(a, lam, lam_g)
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    ak.reset_launches()
    got_in, got_s = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                              torch.tensor(lam_g))
    assert set(ak.LAUNCHES.values()) == {0}   # plain on the CPU
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), **tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               **F64_TOL)
    assert np.abs(np.asarray(want_s)).max() > 0
    assert np.abs(np.asarray(want_in)[-1]).max() > 0     # w's cotangent


def check_kernel_gradient(name, case):
    """The kernel step (its plain versions on CPU tensors: forward
    ``generic2d_step``'s globals flavour, backward ``generic2d_step_b``,
    engine ``cuda_adjoint[<model>,k=1]``) through ``make_objective_run``
    against the eager step's autograd in f32, and the eager f64 gradient
    of ``make_unsteady_gradient`` (InternalTopology: w on the design
    space) against the JAX package's XLA gradient; ``case(cls, model,
    dtype)`` builds the lattice."""
    a = case(JaxLattice, jax_model(name), jnp.float64)
    b64 = case(Lattice, get_model(name), torch.float64)
    m = b64.model
    rng = np.random.default_rng(5)
    theta = 0.2 + 0.6 * rng.random((1,) + b64.shape)
    ref = jax_adjoint.make_unsteady_gradient(
        a.model, jax_adjoint.InternalTopology(a.model), 8, levels=2,
        engine="xla")
    obj_r, g_r, _ = ref(jnp.asarray(theta), a.state, a.params)
    port = make_unsteady_gradient(m, InternalTopology(m), 8, levels=2,
                                  shape=b64.shape, dtype=torch.float64,
                                  device="cpu")
    assert port.engine_name == "eager"
    obj_p, g_p, _ = port(torch.tensor(theta), b64.state, b64.params)
    assert float(obj_p) == pytest.approx(float(obj_r), rel=1e-10)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=1e-9,
                               atol=1e-12)
    assert np.abs(np.asarray(g_r)).max() > 0
    b = case(Lattice, m, torch.float32)
    step = ak.make_diff_step(m, b.shape)
    assert step.engine_name == f"cuda_adjoint[{name},k=1]"
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
