"""The port's ``d2q9_pf`` against the JAX package, on the CPU
(``tests/torch_models2d.py``'s checks): the registry, Init and the eager
step at f64, the plain versions of ``generic2d_step`` (both flavours) and
``generic2d_resident`` against the eager step, the plain engines against
``pallas_generic`` in interpret mode, the device header, the plan and
engines, the bounds, a JAX state carried over; and the reference's
``tests/test_pf.py`` cases of d2q9_pf at their own limits on the port's
eager f64 engine (the plain version of the kernels).
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_models2d as t2  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.models.d2q9 import E  # noqa: E402
from tclb_tpu_torch.ops import lbm  # noqa: E402
from torch_cases import drop_profile  # noqa: E402

NAME = "d2q9_pf"


def test_registry_matches_reference():
    t2.check_registry(NAME)


def test_init_matches_reference():
    t2.check_init(NAME)


def test_eager_step_matches_reference():
    t2.check_eager_step(NAME)


def test_kernels_plain_versions():
    t2.check_kernels_plain(NAME)


def test_plain_engines_match_pallas():
    t2.check_plain_engines(NAME)


def test_device_header_matches_registry():
    t2.check_device_header(NAME)


def test_plan_and_engines():
    t2.check_plan_and_engines(NAME)


def test_bound_counts():
    """A collision node 311 (two flow equilibria 106, the h equilibrium
    89); a Zou/He face 22, a pressure face 2 more."""
    t2.check_bounds(NAME, lambda m, count, n: 311 * count("COLLISION")
                    + 22 * count("WVelocity", "WPressure", "EVelocity",
                                 "EPressure")
                    + 2 * count("WPressure", "EPressure"))


def test_state_carries_over():
    t2.check_state_carries_over(NAME)


def set_h(lat, pf, u=(0.0, 0.0)):
    """tests/test_pf.py:_set_h: h_i = the equilibrium of pf at u."""
    dt = lat.state.fields.dtype
    pf = torch.as_tensor(pf, dtype=dt)
    eq = lbm.equilibrium(E, lbm.weights(E), pf,
                         (torch.full_like(pf, u[0]),
                          torch.full_like(pf, u[1])))
    lat.set_density_planes({f"h[{i}]": eq[i].numpy() for i in range(9)})


def test_pf_mass_conservation_and_advection():
    """tests/test_pf.py:test_pf_mass_conservation_and_advection on the
    port (f64): the phase field's total is conserved to 1e-12 and the
    blob's centroid advects at the flow velocity (rtol 0.15)."""
    m = get_model(NAME)
    ny, nx, u0, T = 48, 48, 0.05, 100
    lat = Lattice(m, (ny, nx), dtype=torch.float64, device="cpu",
                  settings={"nu": 0.1, "M": 0.05, "W": 0.5,
                            "Velocity": u0, "PhaseField": -0.5})
    lat.set_flags(np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16))
    lat.init()
    pf = drop_profile((ny, nx), 8.0)
    set_h(lat, pf, (u0, 0.0))
    total0 = float(lat.get_quantity("PhaseField").sum())
    y, x = np.mgrid[0:ny, 0:nx]
    w = pf + 0.5
    cx0 = float((x * w).sum() / w.sum())
    lat.iterate(T)
    pf1 = lat.get_quantity("PhaseField").numpy()
    assert np.isfinite(pf1).all()
    np.testing.assert_allclose(float(pf1.sum()), total0, rtol=1e-12)
    ang = (x - cx0) * (2 * np.pi / nx)
    shift = np.angle(np.sum((pf1 + 0.5) * np.exp(1j * ang))) * nx \
        / (2 * np.pi)
    np.testing.assert_allclose(shift, u0 * T, rtol=0.15)


def test_pf_walls_and_zouhe_channel():
    """tests/test_pf.py:test_pf_walls_and_zouhe_channel on the port (f64):
    a Zou/He channel around a phase blob stays finite and flows."""
    m = get_model(NAME)
    ny, nx = 24, 64
    lat = Lattice(m, (ny, nx), dtype=torch.float64, device="cpu",
                  settings={"nu": 0.1, "M": 0.05, "W": 0.5,
                            "Velocity": 0.02, "PhaseField": -0.5})
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    set_h(lat, drop_profile((ny, nx), 5.0, center=(ny / 2, 20)),
          (0.02, 0.0))
    lat.iterate(200)
    assert np.isfinite(lat.state.fields.numpy()).all()
    u = lat.get_quantity("U").numpy()
    assert u[0][1:-1, 1:-1].mean() > 0.0
