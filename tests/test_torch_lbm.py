"""The port's LBM helpers (``tclb_tpu_torch/ops/lbm.py``) against the JAX
package's ``ops/lbm.py`` at f64 on random planes made with numpy."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.models import d2q9 as jax_d2q9  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import lbm as jlbm  # noqa: E402
from tclb_tpu_torch.models import get_model  # noqa: E402
from tclb_tpu_torch.ops import lbm  # noqa: E402

RTOL, ATOL = 1e-12, 1e-14    # f64, same operations in the same order
E = jax_d2q9.E


def _planes(seed, n=9, shape=(6, 10)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.01, 0.2, size=(n,) + shape)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_constants():
    np.testing.assert_array_equal(lbm.weights(E), jlbm.weights(E))
    np.testing.assert_array_equal(lbm.opposite(E), jlbm.opposite(E))
    np.testing.assert_array_equal(lbm.mrt_basis_d2q9(E),
                                  jlbm.mrt_basis_d2q9(E))
    assert lbm.CS2 == jlbm.CS2


def test_equilibrium_edot_perm():
    f = _planes(1)
    rho = f.sum(0)
    ux, uy = 0.1 * (f[1] - f[3]), 0.1 * (f[2] - f[4])
    W = jlbm.weights(E)
    got = lbm.equilibrium(E, W, torch.from_numpy(rho),
                          (torch.from_numpy(ux), torch.from_numpy(uy)))
    want = jlbm.equilibrium(E, W, jnp.asarray(rho),
                            (jnp.asarray(ux), jnp.asarray(uy)))
    _close(got, want)
    fj, ft = _both(f)
    for vec in (E[:, 0], E[:, 1], np.array([0, 0.5, 0, 2, 0, 0, 0, 0, 0])):
        _close(lbm.edot(vec, ft), jlbm.edot(vec, fj))
    _close(lbm.perm(ft, jlbm.opposite(E)), jlbm.perm(fj, jlbm.opposite(E)))


def test_moments_roundtrip():
    M = jlbm.mrt_basis_d2q9(E)
    fj, ft = _both(_planes(2))
    mt, mj = lbm.moments(M, ft), jlbm.moments(M, fj)
    _close(mt, mj)
    _close(lbm.from_moments(M, mt), jlbm.from_moments(M, mj))
    np.testing.assert_allclose(lbm.from_moments(M, mt).numpy(), ft.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_present_types():
    jm, tm = jax_model("d2q9"), get_model("d2q9")
    flags = np.full((8, 12), tm.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = tm.flag_for("WVelocity", "MRT", zone=1)
    flags[0, :] = tm.flag_for("Wall")
    flags[3, 4] = tm.flag_for("TopSymmetry", "MRT", "Outlet")
    assert lbm.present_types(tm, flags) == jlbm.present_types(jm, flags)
    assert {"MRT", "WVelocity", "Wall", "TopSymmetry", "Outlet"} <= \
        lbm.present_types(tm, flags)


def test_bgk_collide_and_smagorinsky_rate():
    """``bgk_collide`` with and without the body force, and the
    Smagorinsky relaxation rate, in 2D and in 3D (d3q19)."""
    f = _planes(3)
    fj, ft = _both(f)
    W = jlbm.weights(E)
    for force in (None, (2e-5, -1e-5)):
        got = lbm.bgk_collide(E, W, ft, 1.4, force=force)
        want = jlbm.bgk_collide(E, W, fj, 1.4, force=force)
        for t, j in zip(got[:2], want[:2]):
            _close(t, j)
        for t, j in zip(got[2], want[2]):
            _close(t, j)
    for E_ in (E, lbm.d3q19_velocities()):
        q = len(E_)
        W_ = jlbm.weights(E_)
        fj, ft = _both(_planes(4, n=q))
        rho_t, rho_j = ft.sum(0), fj.sum(0)
        u_t = [lbm.edot(E_[:, a], ft) / rho_t for a in range(E_.shape[1])]
        u_j = [jlbm.edot(E_[:, a], fj) / rho_j for a in range(E_.shape[1])]
        feq_t = lbm.equilibrium(E_, W_, rho_t, tuple(u_t))
        feq_j = jlbm.equilibrium(E_, W_, rho_j, tuple(u_j))
        _close(lbm.smagorinsky_omega_unrolled(E_, ft, feq_t, rho_t, 1.7,
                                              0.16),
               jlbm.smagorinsky_omega_unrolled(E_, fj, feq_j, rho_j, 1.7,
                                               0.16))
