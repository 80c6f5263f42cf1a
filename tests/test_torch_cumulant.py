"""The port's cumulant collision and generic boundary closures against the
JAX package's, at f64 on random near-equilibrium populations:
``ops/cumulant.py`` (moments, shifts, ``collide_d3q27``, ``collide_d2q9``),
``ops/lbm.py``
(``nebb_boundary`` on every face and kind, ``wstack``) and
``models/family.py`` (``boundary_cases`` of ``d3q27_cumulant``,
``add_flux_objectives``)."""

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

from tclb_tpu.models import family as jax_family  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import cumulant as jax_cumulant  # noqa: E402
from tclb_tpu.ops import lbm as jax_lbm  # noqa: E402
from tclb_tpu_torch.models import family, get_model  # noqa: E402
from tclb_tpu_torch.ops import cumulant, lbm  # noqa: E402

jax.config.update("jax_enable_x64", True)

RTOL = 1e-12
SHAPE = (4, 5, 6)
E = cumulant.velocity_set(3)
W = lbm.weights(E)
OPP = lbm.opposite(E)


def populations(seed, shape=SHAPE):
    """d3q27 populations near a flowing equilibrium plus 2% noise."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.03 * rng.standard_normal((3,) + shape)
    usq = (u * u).sum(0)
    f = []
    for k in range(27):
        eu = sum(E[k, a] * u[a] for a in range(3))
        f.append(W[k] * rho * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq))
    return np.stack(f) * (1 + 0.02 * rng.standard_normal((27,) + shape))


def both(a):
    """The same f64 array for each package."""
    return jnp.asarray(a), torch.tensor(a, dtype=torch.float64)


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-15)


def test_constants():
    np.testing.assert_array_equal(cumulant.velocity_set(3),
                                  jax_cumulant.velocity_set(3))
    np.testing.assert_array_equal(cumulant.velocity_set(2),
                                  jax_cumulant.velocity_set(2))
    for name in ("C", "T", "T_INV"):
        np.testing.assert_array_equal(getattr(cumulant, name),
                                      getattr(jax_cumulant, name))


def test_moment_helpers():
    F = populations(1).reshape((3, 3, 3) + SHAPE)
    jF, tF = both(F)
    jr, jj, jm = jax_cumulant._low_moments_d3(jF)
    tr, tj, tm = cumulant._low_moments_d3(tF)
    close(tr, jr)
    for a, b in zip(tj, jj):
        close(a, b)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        close(tm[key], jm[key])
    u = 0.01 + 0.02 * np.random.default_rng(2).standard_normal(SHAPE)
    ju, tu = both(u)
    for axis in range(3):
        close(cumulant._decentralize(tF, tu, axis),
              jax_cumulant._decentralize(jF, ju, axis))
        close(cumulant._contract_axis(tF, cumulant.T, axis),
              jax_cumulant._contract_axis(jF, jax_cumulant.T, axis))
    close(cumulant._from_raw_moments(tF, 3),
          jax_cumulant._from_raw_moments(jF, 3))
    entries = {(0, 0, 0): tF[0, 0, 0], (2, 1, 0): tF[1, 1, 1]}
    jentries = {(0, 0, 0): jF[0, 0, 0], (2, 1, 0): jF[1, 1, 1]}
    close(cumulant._moment_tensor(entries, tF[0, 0, 0], 3),
          jax_cumulant._moment_tensor(jentries, jF[0, 0, 0], 3))


@pytest.mark.parametrize("correlated", [True, False])
@pytest.mark.parametrize("forced,galilean,omega_plane", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True), (False, True, True)])
def test_collide_d3q27(correlated, forced, galilean, omega_plane):
    F = populations(3).reshape((3, 3, 3) + SHAPE)
    jF, tF = both(F)
    if omega_plane:   # a Buffer-layer style per-node omega
        om = np.where(np.arange(np.prod(SHAPE)).reshape(SHAPE) % 3 == 0,
                      1.2, 1.7)
        jom, tom = both(om)
    else:
        jom, tom = 1.6, 1.6
    force = (1e-4, -2e-5, 3e-5) if forced else (0.0, 0.0, 0.0)
    gal = 1.0 if galilean else None
    jout = jax_cumulant.collide_d3q27(jF, jom, 0.9, force=force,
                                      correlated=correlated, galilean=gal)
    tout = cumulant.collide_d3q27(tF, tom, 0.9, force=force,
                                  correlated=correlated, galilean=gal)
    close(tout[0], jout[0])
    close(tout[1], jout[1])
    for a, b in zip(tout[2], jout[2]):
        close(a, b)
    # the collision conserves mass
    rho = F.sum(axis=(0, 1, 2))
    np.testing.assert_allclose(tout[0].numpy().sum(axis=(0, 1, 2)), rho,
                               rtol=1e-13)


def populations_2d(seed, shape=(5, 6)):
    """d2q9 populations in the tensor order near a flowing equilibrium
    plus 2% noise."""
    E2 = cumulant.velocity_set(2)
    W2 = lbm.weights(E2)
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.03 * rng.standard_normal((2,) + shape)
    usq = (u * u).sum(0)
    f = [W2[k] * rho * (1 + 3 * (E2[k, 0] * u[0] + E2[k, 1] * u[1])
                        + 4.5 * (E2[k, 0] * u[0] + E2[k, 1] * u[1]) ** 2
                        - 1.5 * usq) for k in range(9)]
    return np.stack(f) * (1 + 0.02 * rng.standard_normal((9,) + shape))


@pytest.mark.parametrize("correlated", [True, False])
@pytest.mark.parametrize("forced", [False, True])
def test_collide_d2q9(correlated, forced):
    """The 2D cumulant collision (and its raw-moment and centralising
    helpers) at f64, mass conserved."""
    F = populations_2d(4).reshape((3, 3, 5, 6))
    jF, tF = both(F)
    for axis in range(2):
        u = 0.02 + 0.01 * np.random.default_rng(axis).standard_normal((5, 6))
        ju, tu = both(u)
        close(cumulant._centralize(tF, tu, axis),
              jax_cumulant._centralize(jF, ju, axis))
    close(cumulant._raw_moments(tF, 2), jax_cumulant._raw_moments(jF, 2))
    force = (1e-4, -3e-5) if forced else (0.0, 0.0)
    jout = jax_cumulant.collide_d2q9(jF, 1.3, 0.8, force=force,
                                     correlated=correlated)
    tout = cumulant.collide_d2q9(tF, 1.3, 0.8, force=force,
                                 correlated=correlated)
    close(tout[0], jout[0])
    close(tout[1], jout[1])
    for a, b in zip(tout[2], jout[2]):
        close(a, b)
    np.testing.assert_allclose(tout[0].numpy().sum(axis=(0, 1)),
                               F.sum(axis=(0, 1)), rtol=1e-13)


FACES = [(axis, side) for axis in range(3) for side in (+1, -1)]


@pytest.mark.parametrize("axis,side", FACES)
@pytest.mark.parametrize("kind", ["velocity", "pressure"])
@pytest.mark.parametrize("tangential", [False, True])
def test_nebb_boundary(axis, side, kind, tangential):
    f = populations(10 + axis)
    jf, tf = both(f)
    value = np.full(SHAPE, 0.02 if kind == "velocity" else 1.003)
    value[0] *= 1.5                     # a plane, not a constant
    jv, tv = both(value)
    jvt = tvt = None
    if tangential:
        others = [t for t in range(3) if t != axis]
        vt = 0.01 * np.random.default_rng(axis).standard_normal(
            (2,) + SHAPE)
        jvt = {t: jnp.asarray(v) for t, v in zip(others, vt)}
        tvt = {t: torch.tensor(v) for t, v in zip(others, vt)}
    want = jax_lbm.nebb_boundary(E, W, OPP, jf, axis, side, kind, jv, jvt)
    got = lbm.nebb_boundary(E, W, OPP, tf, axis, side, kind, tv, tvt)
    close(got, want)
    # a scalar value works as well
    sval = 0.02 if kind == "velocity" else 1.003
    close(lbm.nebb_boundary(E, W, OPP, tf, axis, side, kind, sval),
          jax_lbm.nebb_boundary(E, W, OPP, jf, axis, side, kind, sval))


def test_wstack():
    v = np.linspace(0.5, 1.5, 30).reshape(5, 6)
    jv, tv = both(v)
    close(lbm.wstack(W, tv), jax_lbm.wstack(W, jv))


def test_boundary_cases_of_d3q27_cumulant():
    """Every case the model declares, each function on the same input."""
    jm, tm = jax_model("d3q27_cumulant"), get_model("d3q27_cumulant")
    rng = np.random.default_rng(5)
    vel = 0.01 + 0.01 * rng.standard_normal(SHAPE)
    den = 1.0 + 0.002 * rng.standard_normal(SHAPE)
    (jvel, tvel), (jden, tden) = both(vel), both(den)
    jcases = jax_family.boundary_cases(jm, E, W, OPP, jvel, jden)
    tcases = family.boundary_cases(tm, E, W, OPP, tvel, tden)
    assert list(tcases) == list(jcases)
    assert set(tcases) == {
        ("Wall", "Solid"), "WVelocity", "WPressure", "EVelocity",
        "EPressure", "SVelocity", "SPressure", "SSymmetry", "NVelocity",
        "NPressure", "NSymmetry"}
    f = populations(6)
    jf, tf = both(f)
    for key in jcases:
        close(tcases[key](tf), jcases[key](jf))
    for axis in range(3):
        np.testing.assert_array_equal(family.mirror_perm(E, axis),
                                      jax_family.mirror_perm(E, axis))


def test_add_flux_objectives():
    """The Inlet/Outlet flux and pressure-loss globals of the family
    skeleton, on d2q9's Karman flags (the model with those globals)."""
    from tclb_tpu.core.lattice import Lattice as JaxLattice
    from tclb_tpu.core.lattice import NodeCtx as JaxNodeCtx
    from tclb_tpu_torch import Lattice
    from tclb_tpu_torch.core.lattice import NodeCtx
    from torch_cases import KARMAN_SETTINGS, karman_flags, random_planes
    a = JaxLattice(jax_model("d2q9"), (16, 40), dtype=jnp.float64,
                   settings=KARMAN_SETTINGS)
    b = Lattice(get_model("d2q9"), (16, 40), dtype=torch.float64,
                settings=KARMAN_SETTINGS, device="cpu")
    for lat in (a, b):
        lat.set_flags(karman_flags(lat.model, 16, 40))
        lat.init()
        lat.set_density_planes(random_planes(lat.model, (16, 40), 8))
    E2 = a.model.ei[:9, :2]
    ja = JaxNodeCtx(a.model, a.state.fields, a.state.fields, a.state.flags,
                    a.params)
    tb = NodeCtx(b.model, b.state.fields, b.state.fields, b.state.flags,
                 b.params)
    jax_family.add_flux_objectives(ja, ja.group("f"), E2)
    family.add_flux_objectives(tb, tb.group("f"), E2)
    got, want = tb.reduce_globals(), ja.reduce_globals()
    close(got, want)
    assert (got.abs() > 0).all()
