"""``d2q9_npe_guo`` on the CPU: the plain band and resident engines of its
generic kernels against the JAX package's generic engines in interpret
mode and its XLA engine (``test_torch_onestage.check_plain_engines``), and
a mirror of tests/test_electrokinetics.py's electro-osmotic profile.  What
the one-stage models share is in ``tests/test_torch_onestage.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from test_torch_onestage import check_plain_engines  # noqa: E402


def test_plain_engines_match_pallas():
    check_plain_engines("d2q9_npe_guo")


def test_npe_guo_eof_profile():
    """tests/test_electrokinetics.py's electro-osmotic profile at 12x8 (a
    potential drop along x through phi_bc zones at W/E pressure faces,
    charged walls): plug-shaped, following (psi - zeta) within 0.08 on
    the normalised shapes.  nu = D = 0.5 to settle in fewer steps."""
    ny, nx = 12, 8
    zeta, n_inf = 0.05, 0.01
    m = get_model("d2q9_npe_guo")
    lat = Lattice(m, (ny, nx), dtype=torch.float64, device="cpu",
                  settings={"n_inf_0": n_inf, "n_inf_1": n_inf,
                            "psi_bc": zeta, "psi0": 0.0, "phi0": 0.0,
                            "phi_bc": 0.0, "el_kbT": 1.0, "epsilon": 1.0,
                            "nu": 0.5, "D": 0.5, "rho_bc": 1.0})
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    flags[1:-1, 0] = m.flag_for("WPressure", "MRT", zone=1)
    flags[1:-1, -1] = m.flag_for("EPressure", "MRT")
    lat.set_flags(flags)
    lat.set_setting("phi_bc", 0.5, zone=1)
    lat.init()
    lat.iterate(1500)
    ux = lat.get_quantity("U").numpy()[0][:, nx // 2]
    psi = lat.get_quantity("Psi").numpy()[:, nx // 2]
    assert np.isfinite(ux).all()
    c = ny // 2
    assert abs(ux[c]) > 5 * abs(ux[1] - ux[c] * (psi[1] - zeta)
                                / (psi[c] - zeta))
    np.testing.assert_allclose(ux[2:-2] / ux[c],
                               ((psi - zeta) / (psi[c] - zeta))[2:-2],
                               atol=0.08)
