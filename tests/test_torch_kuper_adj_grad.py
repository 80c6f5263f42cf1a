"""The reverse of the port's ``d2q9_kuper_adj`` (K7's two-stage reverse,
``generic2d_step_b``'s two launches, through its plain version) against the JAX
package, on the CPU.

``step_b`` on CPU tensors (``step_b_plain``: ``torch.func.vjp`` of the
plain two-stage step) against ``jax.vjp`` of the JAX package's step at
f64, the cotangents of phi and wd included; the decomposition the kernel
runs (stage 1's reverse from the step's output into the cotangent of the
state between the stages, then stage 0's into lam_in, each stage's
settings cotangent added) against ``step_b_plain``; the design gradient
(InternalTopology over wd) against ``jax.grad`` of the JAX package's on
``tests/test_pallas_adjoint.py:test_pallas_kuper_gradient``'s case; the
kernel step's gradient against eager autograd; and the derivative where
CalcPhi's clamp engages, pinned.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu import adjoint as jax_adjoint  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_action_step as jax_step  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.adjoint import (InternalTopology,  # noqa: E402
                                    make_objective_run,
                                    make_unsteady_gradient)
from tclb_tpu_torch.core.lattice import (LatticeState, SimParams,  # noqa: E402
                                         make_stage_step)
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (KUPER_ADJ_SETTINGS, KUPER_SHAPE,  # noqa: E402
                         kuper_adj_design_lattice, paint_rich_kuper_adj)

torch.set_num_threads(1)

NAME = "d2q9_kuper_adj"
F64_TOL = dict(rtol=1e-10, atol=1e-12)
F32_TOL = dict(rtol=2e-5, atol=2e-6)


def lattice_pair(seed=3):
    """The same rich f64 state in both packages (the JAX package's fields
    copied into the port's: the two Inits' phi differ in the last bit on
    a few nodes)."""
    a = paint_rich_kuper_adj(JaxLattice(jax_model(NAME), KUPER_SHAPE,
                                        dtype=jnp.float64,
                                        settings=KUPER_ADJ_SETTINGS), seed)
    b = paint_rich_kuper_adj(Lattice(get_model(NAME), KUPER_SHAPE,
                                     dtype=torch.float64,
                                     settings=KUPER_ADJ_SETTINGS,
                                     device="cpu"), seed)
    b.state.fields.copy_(torch.tensor(np.asarray(a.state.fields)))
    return a, b


def cotangents(m, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m.n_storage,) + KUPER_SHAPE),
            rng.standard_normal(m.n_globals))


def test_step_b_plain_matches_jax_vjp():
    """lam_in (phi's and wd's included) and the settings cotangent of one
    two-stage Iteration (``step_b`` on CPU tensors) against ``jax.vjp`` of
    the JAX package's step at f64 on the rich state, where rho/3 - p > 0
    on every node CalcPhi reads."""
    a, b = lattice_pair()
    m = b.model
    lam, lam_g = cotangents(m)
    step = jax_step(a.model)

    def fn(fields, sett):
        s = step(a.state.replace(fields=fields),
                 a.params.replace(settings=sett))
        return s.fields, s.globals_

    _, vjp = jax.vjp(fn, a.state.fields, a.params.settings)
    want_in, want_s = vjp((jnp.asarray(lam), jnp.asarray(lam_g)))
    want_in = np.asarray(want_in)
    assert np.isfinite(want_in).all()
    f, flags, ztab, args = gk.kernel_inputs(m, b.state, b.params)
    ak.reset_launches()
    got_in, got_s = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                              torch.tensor(lam_g))
    assert set(ak.LAUNCHES.values()) == {0}     # plain on the CPU
    np.testing.assert_allclose(got_in.numpy(), want_in, **F64_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-9, atol=1e-10)
    for plane in ("phi", "wd"):
        assert np.abs(want_in[m.storage_index[plane]]).max() > 0, plane


def test_two_stage_reverse_composes():
    """The decomposition ``generic2d_step_b`` runs for a two-stage plan, on CPU tensors at
    f64: stage 1's (CalcPhi's) vjp at the step's output planes of stage 0
    gives the cotangent of the state between the stages (lam_out passing
    through the planes CalcPhi does not write); stage 0's (Run's) vjp of
    that gives lam_in; the settings cotangents add.  Equal to
    ``step_b_plain`` (the vjp of the whole step) to rounding, phi's and
    wd's cotangents included."""
    _, b = lattice_pair()
    m = b.model
    lam, lam_g = cotangents(m)
    f, flags, ztab, args = gk.kernel_inputs(m, b.state, b.params)
    table = gk._plain_params(ztab, args).zone_table
    sett = torch.tensor(args.settings, dtype=f.dtype)
    planes = sett.reshape(-1, 1, 1).expand((len(args.settings),)
                                           + KUPER_SHAPE)
    zeros = torch.zeros((m.n_globals,), dtype=f.dtype)
    stages = [make_stage_step(m, s) for s in m.actions["Iteration"]]

    def stage_fn(s):
        def fn(fields, setts):
            st = stages[s](LatticeState(fields=fields, flags=flags,
                                        globals_=zeros, iteration=0),
                           SimParams(settings=setts, zone_table=table))
            return st.fields, st.globals_
        return fn

    mid, _ = stage_fn(0)(f, planes)
    _, vjp1 = torch.func.vjp(stage_fn(1), mid, planes)
    lam_mid, s1 = vjp1((torch.tensor(lam), torch.tensor(lam_g)))
    _, vjp0 = torch.func.vjp(stage_fn(0), f, planes)
    lam_in, s0 = vjp0((lam_mid, torch.tensor(lam_g)))
    sett_b = (s1.flatten(1).sum(1) + s0.flatten(1).sum(1))
    want_in, want_s = ak.step_b_plain(f, flags, ztab, args,
                                      torch.tensor(lam),
                                      torch.tensor(lam_g))
    np.testing.assert_allclose(lam_in.numpy(), want_in.numpy(), **F64_TOL)
    np.testing.assert_allclose(sett_b.numpy(), want_s.numpy(), rtol=1e-9,
                               atol=1e-10)
    phi, wd = m.storage_index["phi"], m.storage_index["wd"]
    # CalcPhi reads no phi: the state between the stages takes none; wd's
    # is lam_out's plus CalcPhi's
    assert float(lam_mid[phi].abs().max()) == 0.0
    assert float((lam_mid[wd] - torch.tensor(lam[wd])).abs().max()) > 0
    np.testing.assert_array_equal(lam_in[wd].numpy(), lam_mid[wd].numpy())


def test_design_gradient_matches_jax():
    """tests/test_pallas_adjoint.py:test_pallas_kuper_gradient's case
    (16x128, a vapour drop, walls, the DesignSpace block, WallForceX the
    objective) at f64: the port's eager design gradient (InternalTopology
    over wd, 4 steps) against ``jax.grad`` of the JAX package's XLA
    gradient at rtol 1e-8; rho/3 - p > 0 on every node there, so the
    JAX gradient is finite."""
    a = kuper_adj_design_lattice(JaxLattice, jax_model(NAME), jnp.float64)
    b = kuper_adj_design_lattice(Lattice, get_model(NAME), torch.float64,
                                 device="cpu")
    m = b.model
    theta = InternalTopology(m).get(b.state, b.params)
    ref = jax_adjoint.make_unsteady_gradient(
        a.model, jax_adjoint.InternalTopology(a.model), 4, levels=1,
        engine="xla")
    obj_r, g_r, _ = ref(jnp.asarray(theta.numpy()), a.state, a.params)
    port = make_unsteady_gradient(m, InternalTopology(m), 4, levels=1,
                                  shape=b.shape, dtype=torch.float64,
                                  device="cpu")
    assert port.engine_name == "eager"
    obj_p, g_p, _ = port(theta, b.state, b.params)
    g_r = np.asarray(g_r)
    assert np.isfinite(g_r).all() and np.abs(g_r).max() > 0
    assert float(obj_p) == pytest.approx(float(obj_r), rel=1e-10)
    np.testing.assert_allclose(g_p.numpy(), g_r, rtol=1e-8, atol=1e-14)


def test_gradient_through_the_kernel_step():
    """The kernel step (its plain versions on CPU tensors: forward
    ``generic2d_step``'s globals flavour, backward ``generic2d_step_b`` (two launches a call),
    engine ``cuda_adjoint[d2q9_kuper_adj,k=1]``) through
    ``make_objective_run`` against the eager step's autograd in f32."""
    m = get_model(NAME)
    b = kuper_adj_design_lattice(Lattice, m, torch.float32, device="cpu")
    step = ak.make_diff_step(m, b.shape)
    assert step.engine_name == f"cuda_adjoint[{NAME},k=1]"
    design = InternalTopology(m)
    theta = design.get(b.state, b.params)
    p = theta.clone().requires_grad_(True)
    st, pa = design.put(p, b.state, b.params)
    obj, fin = make_objective_run(m, 4, levels=1, step=step)(st, pa)
    got, = torch.autograd.grad(obj, p)
    eager = make_unsteady_gradient(m, design, 4, levels=1, engine="eager",
                                   device="cpu")
    obj_e, want, fin_e = eager(theta, b.state, b.params)
    assert float(obj.detach()) == pytest.approx(float(obj_e), rel=1e-6)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(fin.fields.detach(), fin_e.fields,
                               **F32_TOL)


def test_sqrt_clamp_derivative_where_it_engages():
    """CalcPhi's ``sqrt(max(rho/3 - p, 0))`` where rho/3 - p < 0 (a
    temperature and Magic at which p exceeds rho/3 on the liquid, not on
    the vapour): phi is 0 and its derivative is NaN in JAX (``0 x inf``),
    0 in the port (the eager model's torch.clamp, as the kernel's reverse
    gives); where it is positive the two agree.  A 4x40 periodic lattice,
    liquid on columns 4..19 and vapour elsewhere: after one step CalcPhi
    at column c reads the populations of columns c - 2 .. c + 2, so the
    clamp engages on columns 6..17 and the populations of columns 8..15
    reach no other CalcPhi node; those of 26..35 reach vapour only."""
    shape = (4, 40)
    sett = {"Temperature": 1.0, "Magic": 0.05, "Density": 0.0145,
            "FAcc": 1.0}
    a = JaxLattice(jax_model(NAME), shape, dtype=jnp.float64, settings=sett)
    b = Lattice(get_model(NAME), shape, dtype=torch.float64, settings=sett,
                device="cpu")
    for lat in (a, b):
        flags = np.full(shape, lat.model.flag_for("MRT"), np.uint16)
        flags[:, 4:20] = lat.model.flag_for("MRT", zone=1)
        lat.set_flags(flags)
        lat.set_setting("Density", 3.26, zone=1)
        lat.init()
    b.state.fields.copy_(torch.tensor(np.asarray(a.state.fields)))
    m = b.model
    phi = m.storage_index["phi"]
    out = b.fields_raw()[phi]
    assert (out[:, 6:18] == 0).all() and (out[:, 22:38] > 0).all()
    lam = np.zeros((m.n_storage,) + shape)
    lam[phi] = 1.0
    step = jax_step(a.model)
    _, vjp = jax.vjp(lambda f: step(a.state.replace(fields=f),
                                    a.params).fields, a.state.fields)
    want, = vjp(jnp.asarray(lam))
    want = np.asarray(want)
    f, flags, ztab, args = gk.kernel_inputs(m, b.state, b.params)
    got, _ = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                       torch.zeros(m.n_globals, dtype=torch.float64))
    got = got.numpy()
    assert np.isnan(want[:9, :, 8:16]).all()
    assert (got[:9, :, 8:16] == 0).all()
    np.testing.assert_allclose(got[:9, :, 26:36], want[:9, :, 26:36],
                               **F64_TOL)
    assert np.abs(want[:9, :, 26:36]).max() > 0
