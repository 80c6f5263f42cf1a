"""The port's ``d2q9_diff`` against the JAX package, on the CPU
(``tests/torch_models2d.py``'s checks): the registry, Init and the eager
step at f64, the plain versions of ``generic2d_step`` (both flavours) and
``generic2d_resident`` against the eager step, the plain engines against
``pallas_generic`` in interpret mode, the device header, the plan and
engines, the bounds, a JAX state carried over with its design plane w;
the reverse (``generic2d_step_b``'s plain version against ``jax.vjp``),
the gradient through the kernel step and the reference's
``tests/test_models.py:test_diff_source_gradient``.
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
from tclb_tpu_torch.adjoint import (InternalTopology,  # noqa: E402
                                    make_unsteady_gradient)

NAME = "d2q9_diff"


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
    """Every node its concentration (8); a collision node 9 x 18 and 4;
    an Outlet node 1."""
    t2.check_bounds(NAME, lambda m, count, n: 8 * n
                    + 166 * count("COLLISION") + count("Outlet"))


def test_state_carries_over():
    t2.check_state_carries_over(NAME)


def test_step_b_plain_matches_jax_vjp():
    t2.check_step_b_plain(NAME)


def _source_case(cls, model, dtype):
    """tests/test_models.py:test_diff_source_gradient's 10x10 BGK box
    with a DesignSpace block (its settings; TotalC the objective)."""
    shape = (10, 10)
    kw = {"device": "cpu"} if cls is Lattice else {}
    lat = cls(model, shape, dtype=dtype,
              settings={"Diffusivity": 0.1, "UX": 0.02, "Source": 0.01,
                        "TotalCInObj": 1.0}, **kw)
    flags = np.full(shape, model.flag_for("BGK"), dtype=np.uint16)
    flags[4:6, 4:6] |= model.flag_for("DesignSpace")
    lat.set_flags(flags)
    lat.init()
    return lat


def test_gradient_through_the_kernel_step():
    t2.check_kernel_gradient(NAME, _source_case)


def test_diff_source_gradient():
    """tests/test_models.py:test_diff_source_gradient on the port: the
    source design field drives the total concentration (six steps, one
    checkpoint level, the eager f64 engine on the CPU)."""
    m = get_model(NAME)
    lat = _source_case(Lattice, m, torch.float64)
    design = InternalTopology(m)
    gf = make_unsteady_gradient(m, design, 6, levels=1, device="cpu",
                                dtype=torch.float64)
    obj, g, _ = gf(design.get(lat.state, lat.params), lat.state,
                   lat.params)
    assert np.isfinite(float(obj))
    assert float(g.abs().max()) > 0
