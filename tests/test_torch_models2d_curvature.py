"""The port's ``d2q9_pf_curvature`` against the JAX package, on the CPU
(``tests/torch_models2d.py``'s checks): the registry, Init (its CalcPhi
stage included) and the eager step at f64, the plain versions of
``generic2d_step`` (both flavours; the ring form) and
``generic2d_resident`` against the eager step, the plain engines against
``pallas_generic`` in interpret mode, the device header, the plan and
engines, the bounds, a JAX state carried over; the -999 wall sentinel
through the bf16 rungs (raw and shifted); and the reference's
``tests/test_pf.py`` cases of the model at their own limits on the port's
eager f64 engine (the plain version of the kernels).
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

import torch_models2d as t2  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.core import shift as ddf  # noqa: E402
from tclb_tpu_torch.models import d2q9_pf_curvature as pfc  # noqa: E402
from torch_cases import drop_profile  # noqa: E402
from test_torch_models2d_pf import set_h  # noqa: E402

NAME = "d2q9_pf_curvature"


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
    """A collision node 386 (two flow equilibria 106, the h equilibrium
    89, the repaired stencil's curvature and force 110); a Zou/He face 22,
    a pressure face 75 more (h pinned at its velocity); every node
    CalcPhi's 8."""
    t2.check_bounds(NAME, lambda m, count, n: 386 * count("COLLISION")
                    + 22 * count("WVelocity", "WPressure", "EVelocity",
                                 "EPressure")
                    + 75 * count("WPressure", "EPressure") + 8 * n)


def test_state_carries_over():
    t2.check_state_carries_over(NAME)


# --------------------------------------------------------------------------- #
# the wall sentinel through the storage ladder
# --------------------------------------------------------------------------- #


def _walled(dtype, storage_dtype=None, storage_repr=None):
    """tests/test_pf.py:test_pf_curvature_wall_sentinel_stencil's 16x32
    channel (walls top and bottom) with a drop of the phase field."""
    m = get_model(NAME)
    ny, nx = 16, 32
    kw = {} if storage_dtype is None else dict(storage_dtype=storage_dtype,
                                               storage_repr=storage_repr)
    lat = Lattice(m, (ny, nx), dtype=dtype, device="cpu",
                  settings={"nu": 0.1, "omega_l": 1.0, "M": 0.05, "W": 0.5,
                            "PhaseField": -0.5, "SurfaceTensionRate": 0.05},
                  **kw)
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


def _stencil(phi):
    """The nine phis of every node (phi at x + e_j, periodic)."""
    E = pfc.E
    return [torch.roll(phi, (-int(E[j, 1]), -int(E[j, 0])), dims=(0, 1))
            for j in range(9)]


@pytest.mark.parametrize("rep", ["raw", "shifted"])
def test_sentinel_survives_bf16(rep):
    """phi is a Field: no DDF shift on either rung, so the -999 CalcPhi
    writes on a wall narrows to -1000 in bf16 raw and shifted alike, still
    below the test's -998; every link of every node's stencil is
    classified as f32 classifies it, and the repaired stencil from the
    bf16 values takes the same substitutes (each value within a bf16
    rounding of f32's)."""
    m = get_model(NAME)
    assert ddf.storage_shift(m)[m.storage_index["phi"]] == 0.0
    assert ddf.storage_shift(m)[m.storage_index["h[0]"]] != 0.0
    ref = _walled(torch.float32)
    bf = _walled(torch.float32, torch.bfloat16, rep)
    phi32 = ref.get_density("phi")
    set_pf = drop_profile(ref.shape, 5.0) \
        + 0.001 * np.random.default_rng(1).standard_normal(ref.shape)
    wall = np.zeros(ref.shape, dtype=bool)
    wall[0, :] = wall[-1, :] = True
    phi = np.where(wall, pfc.SENTINEL, set_pf)
    for lat in (ref, bf):
        lat.set_density("phi", phi)
    phi32 = ref.get_density("phi")
    phib = bf.get_density("phi")
    assert bf.state.fields.dtype == torch.bfloat16
    assert torch.equal(phib[torch.as_tensor(wall)],
                       torch.full((int(wall.sum()),), -1000.0))
    s32, sb = _stencil(phi32), _stencil(phib)
    for a, b in zip(s32, sb):
        assert torch.equal(a > pfc.SENTINEL + 1.0, b > pfc.SENTINEL + 1.0)
    r32 = pfc.repaired_stencil(s32)
    rb = pfc.repaired_stencil(sb)
    for j, (a, b) in enumerate(zip(r32, rb)):
        assert bool((a > pfc.SENTINEL + 1.0).all()), j
        torch.testing.assert_close(b, a, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("rep", ["raw", "shifted"])
def test_sentinel_through_narrowed_steps(rep):
    """Thirty steps of the narrowed eager engine (the bf16 kernels' plain
    version) keep the walls' phi at -1000 and every value finite, and the
    curvature finite next to the walls."""
    lat = _walled(torch.float32, torch.bfloat16, rep)
    assert lat.engine_name == f"eager[bfloat16/{rep}]"
    lat.iterate(30)
    phi = lat.get_density("phi")
    assert bool((phi[0] == -1000.0).all() and (phi[-1] == -1000.0).all())
    assert bool(torch.isfinite(lat.state.fields.float()).all())
    assert bool(torch.isfinite(lat.get_quantity("Curvature")).all())


# --------------------------------------------------------------------------- #
# the reference's physics tests
# --------------------------------------------------------------------------- #


def test_pf_curvature_wall_sentinel_stencil():
    """tests/test_pf.py:test_pf_curvature_wall_sentinel_stencil on the
    port (f64): walls hold -999, thirty steps stay finite, the curvature
    too."""
    lat = _walled(torch.float64)
    assert bool((lat.get_density("phi")[0] == -999.0).all())
    lat.iterate(30)
    assert bool(torch.isfinite(lat.state.fields[:18]).all())
    assert bool(torch.isfinite(lat.get_quantity("Curvature")).all())


def test_pf_curvature_matches_drop_radius():
    """tests/test_pf.py:test_pf_curvature_matches_drop_radius on the port
    (f64): the curvature quantity in the interface band of a drop of
    radius 16 is 1/R within 10%, and fifty steps with surface tension on
    stay finite."""
    m = get_model(NAME)
    ny = nx = 64
    R, w = 16.0, 0.25
    lat = Lattice(m, (ny, nx), dtype=torch.float64, device="cpu",
                  settings={"nu": 0.1, "omega_l": 1.0, "M": 0.05, "W": w,
                            "PhaseField": -0.5, "SurfaceTensionRate": 0.0})
    lat.set_flags(np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16))
    lat.init()
    pf = drop_profile((ny, nx), R, width=w)
    set_h(lat, pf)
    lat.set_density("phi", pf)
    curv = lat.get_quantity("Curvature").numpy()
    band = np.abs(pf) < 0.3
    np.testing.assert_allclose(curv[band].mean(), 1.0 / R, rtol=0.1)
    lat.set_setting("SurfaceTensionRate", 0.1)
    lat.iterate(50)
    assert bool(torch.isfinite(lat.state.fields).all())
