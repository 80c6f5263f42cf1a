"""The port's ``wave`` and ``wave2d`` against the JAX package, on the CPU
(``tests/torch_models2d.py``'s checks): the registry, Init and the eager
step at f64, the plain versions of ``generic2d_step`` (both flavours) and
``generic2d_resident`` against the eager step, the plain engines against
``pallas_generic`` in interpret mode, the device headers, the plans and
engines, the bounds, a JAX state carried over; wave2d's reverse
(``generic2d_step_b``'s plain version against ``jax.vjp``) and its
gradient through the kernel step; and the reference's
``tests/test_models.py`` cases of both models on the port's engines.
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
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402

MODELS = ("wave", "wave2d")


@pytest.mark.parametrize("name", MODELS)
def test_registry_matches_reference(name):
    t2.check_registry(name)


@pytest.mark.parametrize("name", MODELS)
def test_init_matches_reference(name):
    t2.check_init(name)


@pytest.mark.parametrize("name", MODELS)
def test_eager_step_matches_reference(name):
    t2.check_eager_step(name)


@pytest.mark.parametrize("name", MODELS)
def test_kernels_plain_versions(name):
    t2.check_kernels_plain(name)


@pytest.mark.parametrize("name", MODELS)
def test_plain_engines_match_pallas(name):
    t2.check_plain_engines(name)


@pytest.mark.parametrize("name", MODELS)
def test_device_header_matches_registry(name):
    t2.check_device_header(name)


@pytest.mark.parametrize("name", MODELS)
def test_plan_and_engines(name):
    t2.check_plan_and_engines(name)


@pytest.mark.parametrize("name,flops", [
    ("wave", lambda m, count, n: 10 * n),
    ("wave2d", lambda m, count, n: 10 * n + 2 * count("Obj1"))])
def test_bound_counts(name, flops):
    t2.check_bounds(name, flops)


@pytest.mark.parametrize("name", MODELS)
def test_state_carries_over(name):
    t2.check_state_carries_over(name)


def test_wave2d_step_b_plain_matches_jax_vjp():
    t2.check_step_b_plain("wave2d")


def _wave2d_case(cls, model, dtype):
    """tests/test_models.py's oscillating 16x16 box (walls, a Solid
    source) with a DesignSpace block and an Obj1 patch, so that TotalDiff
    depends on the design w."""
    shape = (16, 16)
    kw = {"device": "cpu"} if cls is Lattice else {}
    lat = cls(model, shape, dtype=dtype,
              settings={"WaveK": 0.1, "Loss": 0.99, "SolidH": 1.0,
                        "TotalDiffInObj": 1.0}, **kw)
    flags = np.zeros(shape, dtype=np.uint16)
    flags[0, :] = flags[-1, :] = flags[:, 0] = flags[:, -1] = \
        model.flag_for("Wall")
    flags[7:9, 7:9] = model.flag_for("Solid")
    flags[3:6, 3:13] |= np.uint16(model.flag_for("DesignSpace"))
    flags[10:13, 4:12] |= np.uint16(model.flag_for("Obj1"))
    lat.set_flags(flags)
    lat.init()
    return lat


def test_wave2d_gradient_through_the_kernel_step():
    t2.check_kernel_gradient("wave2d", _wave2d_case)


def test_wave2d_oscillates():
    """tests/test_models.py:test_wave2d_oscillates on the resident engine
    (its plain version at f32, on the CPU): the wave leaves the Solid
    source and reaches the far rows."""
    m = get_model("wave2d")
    shape = (16, 16)
    lat = Lattice(m, shape, dtype=torch.float32, device="cpu",
                  settings={"WaveK": 0.1, "Loss": 1.0, "SolidH": 1.0})
    flags = np.full(shape, 0, dtype=np.uint16)
    flags[0, :] = flags[-1, :] = flags[:, 0] = flags[:, -1] = \
        m.flag_for("Wall")
    flags[7:9, 7:9] = m.flag_for("Solid")
    lat.set_flags(flags)
    lat.init()
    it, tag = gk.select_engine(m, shape, torch.float32)
    assert tag == "cuda_generic_resident[wave2d,fuse=N]"
    h0 = lat.get_quantity("H").numpy()
    assert h0[7, 7] == 1.0
    lat.state = it(lat.state, lat.params, 30)
    h = lat.get_quantity("H").numpy()
    assert np.isfinite(h).all()
    assert abs(h[7, 7]) < 1.0
    assert np.abs(h[3, :]).max() > 1e-4


def test_wave_fields_dirichlet():
    """tests/test_models.py:test_wave_fields_dirichlet on the resident
    engine (its plain version, on the CPU): the Dirichlet row stays
    pinned to zone 1's Value and the wave propagates inward."""
    m = get_model("wave")
    shape = (12, 12)
    lat = Lattice(m, shape, dtype=torch.float32, device="cpu",
                  settings={"Speed": 0.2})
    flags = np.zeros(shape, dtype=np.uint16)
    flags[0, :] = m.flag_for("Dirichlet", zone=1)
    lat.set_flags(flags)
    lat.set_setting("Value", 1.0, zone=1)
    lat.init()
    it, tag = gk.select_engine(m, shape, torch.float32)
    assert tag == "cuda_generic_resident[wave,fuse=N]"
    lat.state = it(lat.state, lat.params, 40)
    u = lat.get_quantity("U").numpy()
    assert np.isfinite(u).all()
    assert u[0, 5] == pytest.approx(1.0)
    assert np.abs(u[4, :]).max() > 1e-5
