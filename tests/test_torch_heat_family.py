"""``d2q9_heat``, ``d2q9_heat_conjugate`` and ``d2q9_hb`` on the CPU: the
plain band and resident engines of their generic kernels against the JAX
package's generic engines in interpret mode and its XLA engine
(``test_torch_onestage.check_plain_engines``), and the conjugate model's
flux continuity (a mirror of tests/test_physics_constitutive.py:252).
What the one-stage models share is in ``tests/test_torch_onestage.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from test_torch_onestage import check_plain_engines  # noqa: E402


@pytest.mark.parametrize("name", ['d2q9_heat', 'd2q9_heat_conjugate', 'd2q9_hb'])
def test_plain_engines_match_pallas(name):
    check_plain_engines(name)


def test_conjugate_flux_continuity():
    """tests/test_physics_constitutive.py:252 at 4x32: steady conduction
    through a fluid|solid bilayer between two Heaters; the temperature is
    continuous at the interface and the slopes' ratio is SolidAlfa /
    FluidAlfa within 5%."""
    n, h = 32, 4
    alfa_f, alfa_s = 0.3, 0.1
    m = get_model("d2q9_heat_conjugate")
    lat = Lattice(m, (h, n), dtype=torch.float64, device="cpu",
                  settings={"omega": 1.0, "InletVelocity": 0.0,
                            "FluidAlfa": alfa_f, "SolidAlfa": alfa_s,
                            "InitTemperature": 1.0,
                            "HeaterTemperature": 2.0})
    flags = np.full((h, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, n // 2:-1] = m.flag_for("Solid")
    flags[:, 0] = m.flag_for("MRT", "Heater")
    flags[:, -1] = m.flag_for("MRT", "Heater", zone=1)
    lat.set_flags(flags)
    lat.set_setting("HeaterTemperature", 0.5, zone=1)
    lat.init()
    prev = None
    for _ in range(20):
        lat.iterate(250)
        T = lat.get_quantity("T").numpy()[0]
        if prev is not None and np.abs(T - prev).max() < 1e-9:
            break
        prev = T
    mid = n // 2
    jump = abs(T[mid] - T[mid - 1])
    assert jump < 4 * max(abs(T[mid - 1] - T[mid - 2]),
                          abs(T[mid + 2] - T[mid + 1])) + 1e-12
    xs = np.arange(n)
    slope_f = np.polyfit(xs[3:mid - 3], T[3:mid - 3], 1)[0]
    slope_s = np.polyfit(xs[mid + 3:n - 3], T[mid + 3:n - 3], 1)[0]
    assert abs(slope_f / slope_s - alfa_s / alfa_f) / (alfa_s / alfa_f) \
        < 0.05
