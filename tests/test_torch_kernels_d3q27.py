"""The d3q27_cumulant collide-stream kernels of
``tclb_tpu_torch/ops/d3q27_kernels.py``.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels in interpret mode (the band engine
at fuse 1 and 2, as ``tests/test_pallas3d.py`` runs them), and the port's
``Lattice.iterate`` with the kernel engine selected is held against the JAX
package's XLA path.  The CUDA kernels themselves are held against these
plain versions on the card by ``tests/test_torch_cuda.py``.
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

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_d3q  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.ops import d2q9_kernels  # noqa: E402
from tclb_tpu_torch.ops import d3q27_kernels as dk  # noqa: E402
from torch_cases import (RICH3D_SETTINGS, SHAPE3D, paint_rich_3d,  # noqa: E402
                         rich_flags_3d)

# f32 engines against each other: tests/test_fastpath.py's tolerances
FIELDS_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
NAME = "d3q27_cumulant"


def lattice_pair(seed):
    """The same f32 state in both packages."""
    a = JaxLattice(jax_model(NAME), SHAPE3D, dtype=jnp.float32,
                   settings=RICH3D_SETTINGS)
    b = Lattice(get_model(NAME), SHAPE3D, dtype=torch.float32,
                settings=RICH3D_SETTINGS, device="cpu")
    return paint_rich_3d(a, seed), paint_rich_3d(b, seed)


def _assert_fields(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FIELDS_TOL)


@pytest.mark.parametrize("fuse", [1, 2])
def test_plain_band_matches_pallas_band(fuse):
    """niter = 5: at fuse=2 two fused launches and one single step, at
    fuse=1 five single steps; every boundary case, the turbulent inlet's
    SynthT terms, the Buffer layer and both averages."""
    a, b = lattice_pair(2)
    it = pallas_d3q.make_pallas_iterate(a.model, SHAPE3D, jnp.float32,
                                        interpret=True, fuse=fuse)
    want = it(jax.tree.map(jnp.copy, a.state), a.params, 5)
    got = dk.make_band_iterate(b.model, SHAPE3D, fuse=fuse)(
        b.state, b.params, 5)
    _assert_fields(got.fields, want.fields)
    assert got.iteration == int(want.iteration) == 5
    assert not got.globals_.any()


def test_lattice_kernel_engine_matches_xla(monkeypatch):
    """Lattice.iterate(6) with the kernel engine set on CPU tensors (two
    fused launches, one single step, then the eager globals step) against
    the JAX package's XLA path."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")     # the JAX package's XLA path
    a, b = lattice_pair(3)
    b._fast, b._fast_name = dk.select_engine(b.model, b.shape, b.dtype)
    b._fast_tried = True
    a.iterate(6)
    b.iterate(6)
    assert b.engine_name == "cuda_d3q27_band[d3q27_cumulant,fuse=2]"
    _assert_fields(b.state.fields, a.state.fields)
    np.testing.assert_allclose(b.get_globals()["Flux"],
                               a.get_globals()["Flux"], **GLOBALS_TOL)
    assert b.state.iteration == 6


def test_cpu_tensor_takes_plain_version_without_counting():
    _, b = lattice_pair(4)
    f, flags, ztab, args = dk.kernel_inputs(b.model, b.state, b.params)
    dk.reset_launches()
    for name, (fn, n) in dk.WRAPPERS.items():
        got = fn(f, flags, ztab, args)
        want = dk.plain_steps(f, flags, ztab, args, n)
        assert torch.equal(got, want), name
        assert torch.equal(got[27:30], f[27:30])   # SynthT carried through
    assert dk.LAUNCHES == {name: 0 for name in dk.KERNELS}


def test_engine_choice(monkeypatch):
    tm = get_model(NAME)
    assert dk.supports(tm, (48, 48, 256), torch.float32)
    assert dk.supports(tm, (5, 7, 11), torch.float32)   # no alignment needed
    assert not dk.supports(tm, (48, 48, 256), torch.float64)
    assert not dk.supports(get_model("d2q9"), (48, 256), torch.float32)
    assert dk.select_engine(tm, (48, 48, 256), torch.float32)[1] \
        == "cuda_d3q27_band[d3q27_cumulant,fuse=2]"
    assert dk.select_engine(tm, (8, 8, 8), torch.float64) == (None, None)
    # each module accepts its own model only
    assert d2q9_kernels.select_engine(tm, (48, 48, 256),
                                      torch.float32) == (None, None)
    assert dk.select_engine(get_model("d2q9"), (100, 1024),
                            torch.float32) == (None, None)
    # the Lattice takes the kernels on the card only
    monkeypatch.delenv("TCLB_FASTPATH", raising=False)
    auto = Lattice(tm, (4, 4, 8), dtype=torch.float32, device="cpu")
    assert auto.engine_name == "eager"


def test_step2_planes():
    """z planes per d3q27_step2 block at 3d_channel's shape: 48 columns of
    32x8 on a 132-SM card, one block per SM."""
    assert dk.step2_planes((48, 48, 256), 132) == 6
    for shape, slots in (((12, 8, 64), 132), ((7, 9, 40), 4),
                         ((48, 48, 256), 264)):
        zc = dk.step2_planes(shape, slots)
        assert 1 <= zc <= shape[0]


def test_bound_counts():
    """Bytes and operations of one launch, as chip_smoke.py reports them."""
    tm = get_model(NAME)
    n = int(np.prod(SHAPE3D))
    assert dk.launch_bytes(tm, SHAPE3D) == (2 * 34 + 1) * 4 * n + 3 * 64 * 4
    # a d3q27 face by hand: tangential and outgoing sums 8 + 8, rho 4,
    # rho un and 9 normal terms, per tangential axis 5 + 1 + 6 x 2, the 9
    # bounce-back adds -- 75; the turbulent inlet adds 3 per tangential
    # axis and 4 for its velocities -- 85
    for axis in range(3):
        assert dk._nebb_flops(axis) == 75
    assert dk._nebb_flops(0, turbulent=True) == 85
    flags = rich_flags_3d(tm, *SHAPE3D).astype(np.int64)

    def count(name):
        t = tm.node_types[name]
        return int(((flags & t.mask) == t.value).sum())

    coll = int(((flags & tm.group_masks["COLLISION"]) != 0).sum())
    faces = sum(count(f + k) for f in "WENS" for k in ("Velocity",
                                                       "Pressure"))
    assert 0 < coll < n and faces > 0
    assert dk.node_step_flops(tm, flags) == (
        89 * n + 448 * coll + 75 * faces + 85 * count("WVelocityTurbulent"))


def test_layout_check():
    with pytest.raises(ValueError, match="storage"):
        dk.check_layout(get_model("d2q9"))
