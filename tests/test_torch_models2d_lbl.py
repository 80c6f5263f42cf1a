"""The port's ``d2q9_pp_LBL`` against the JAX package, on the CPU
(``tests/torch_models2d.py``'s checks): the registry, Init (its calcPsi
stage included) and the eager step at f64, the plain versions of
``generic2d_step`` (both flavours; the ring form) and
``generic2d_resident`` against the eager step, the plain engines against
``pallas_generic`` in interpret mode, the device header, the plan and
engines, the bounds, a JAX state carried over; and the reference's
``tests/test_pp.py:test_lbl_quantities_and_walls`` at its own limits on the
port's eager f64 engine (the plain version of the kernels).
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

NAME = "d2q9_pp_LBL"


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
    """A collision node 369 (9 x 28 for the forced BGK); a Zou/He face
    22, the equilibrium inlet 53; every node calcPsi's 32."""
    t2.check_bounds(NAME, lambda m, count, n: 369 * count("COLLISION")
                    + 22 * count("WPressure", "EVelocity", "EPressure")
                    + 53 * count("WVelocity") + 32 * n)


def test_state_carries_over():
    t2.check_state_carries_over(NAME)


def test_lbl_quantities_and_walls():
    """tests/test_pp.py:test_lbl_quantities_and_walls on the port (f64): a
    walled duct stays finite and the pressure quantity is the
    Carnahan-Starling closed form at a bulk node (rtol 1e-12)."""
    m = get_model(NAME)
    ny, nx = 32, 48
    lat = Lattice(m, (ny, nx), dtype=torch.float64, device="cpu",
                  settings={"Density": 0.35, "T": 0.35, "nu": 1 / 6})
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    lat.iterate(300)
    rho = lat.get_quantity("Rho").numpy()
    p = lat.get_quantity("P").numpy()
    assert np.isfinite(rho).all() and np.isfinite(p).all()
    r = rho[ny // 2, nx // 2]
    bp = r * 1.0 / 4.0
    p_ref = r * 0.25 * 0.35 * (1 + bp + bp ** 2 - bp ** 3) / (1 - bp) ** 3 \
        - 0.25 * r * r
    np.testing.assert_allclose(p[ny // 2, nx // 2], p_ref, rtol=1e-12)
