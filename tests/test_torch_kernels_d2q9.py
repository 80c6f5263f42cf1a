"""The d2q9 collide-stream kernels of ``tclb_tpu_torch/ops/d2q9_kernels.py``.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels in interpret mode (the resident
engine with its single-step tail, the band engine at fuse 1 and 2), and the
port's ``Lattice.iterate`` with the kernel engine selected is held against
the JAX package's ``TCLB_FASTPATH=force`` engine.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_d2q9  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.ops import d2q9_kernels as dk  # noqa: E402
from torch_cases import RICH_SETTINGS, paint_rich, rich_flags  # noqa: E402

# f32 engines against each other: tests/test_fastpath.py's tolerances
FIELDS_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
SHAPE = (32, 64)


def lattice_pair(seed):
    """The same f32 state in both packages."""
    a = JaxLattice(jax_model("d2q9"), SHAPE, dtype=jnp.float32,
                   settings=RICH_SETTINGS)
    b = Lattice(get_model("d2q9"), SHAPE, dtype=torch.float32,
                settings=RICH_SETTINGS, device="cpu")
    return paint_rich(a, seed), paint_rich(b, seed)


def use_kernel_engine(lat):
    """Put ``lat`` on the kernel engine ``supports()`` picks, which on CPU
    tensors runs each kernel's plain version (the Lattice itself takes the
    kernels on the card only)."""
    lat._fast, lat._fast_name = dk.select_engine(lat.model, lat.shape,
                                                 lat.dtype)
    lat._fast_tried = True


def _assert_fields(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FIELDS_TOL)


# --------------------------------------------------------------------------- #
# plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #


def test_plain_resident_matches_pallas_resident():
    """niter = 11: one 8-step launch, then three single steps."""
    a, b = lattice_pair(1)
    jit = pallas_d2q9.make_resident_iterate(a.model, SHAPE, jnp.float32,
                                            interpret=True)
    want = jit(a.state, a.params, 11)
    got = dk.make_resident_iterate(b.model, SHAPE)(b.state, b.params, 11)
    _assert_fields(got.fields, want.fields)
    assert got.iteration == int(want.iteration) == 11
    assert not got.globals_.any()


@pytest.mark.parametrize("fuse,niter", [(1, 3), (2, 5)])
def test_plain_band_matches_pallas_band(fuse, niter):
    """fuse=2 with an odd niter runs two fused pairs and one single step."""
    a, b = lattice_pair(2)
    jit = pallas_d2q9.make_pallas_iterate(a.model, SHAPE, jnp.float32,
                                          interpret=True, fuse=fuse)
    want = jit(a.state, a.params, niter)
    got = dk.make_band_iterate(b.model, SHAPE, fuse=fuse)(
        b.state, b.params, niter)
    _assert_fields(got.fields, want.fields)
    assert got.iteration == niter
    assert not got.globals_.any()


def test_lattice_kernel_engine_matches_pallas_engine(monkeypatch):
    """Lattice.iterate(21) with the kernel engine set on CPU tensors: 20
    plain steps (two resident launches and a four-step tail) plus the
    eager globals step, against the JAX package's forced Pallas engine."""
    monkeypatch.setenv("TCLB_FASTPATH", "force")    # the JAX package's knob
    a, b = lattice_pair(3)
    use_kernel_engine(b)
    a.iterate(21)
    b.iterate(21)
    assert a._fast_name == "pallas_resident[d2q9,fuse=8]"
    assert b.engine_name == "cuda_d2q9_resident[d2q9,fuse=8]"
    _assert_fields(b.state.fields, a.state.fields)
    ga, gb = a.get_globals(), b.get_globals()
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], **GLOBALS_TOL,
                                   err_msg=f"global {k}")
    assert any(abs(v) > 0 for v in gb.values())
    assert b.state.iteration == 21


# --------------------------------------------------------------------------- #
# wrapper contract and engine choice (no card needed)
# --------------------------------------------------------------------------- #


def test_cpu_tensor_takes_plain_version_without_counting():
    _, b = lattice_pair(4)
    f, flags, vel, den, args = dk.kernel_inputs(b.model, b.state, b.params)
    dk.reset_launches()
    for name, (fn, n) in dk.WRAPPERS.items():
        got = fn(f, flags, vel, den, args)
        want = dk.plain_steps(f, flags, vel, den, args, n)
        assert torch.equal(got, want), name
    assert not any(dk.LAUNCHES.values())
    # the BC planes are carried through unchanged
    assert torch.equal(got[9:], f[9:])


def test_engine_choice(monkeypatch):
    tm = get_model("d2q9")
    # karman.xml's 1024x100 fits the L2 budget; bench.py's 1024^2 does not
    assert dk.supports_resident(tm, (100, 1024), torch.float32)
    assert not dk.supports_resident(tm, (1024, 1024), torch.float32)
    assert dk.supports(tm, (1024, 1024), torch.float32)
    assert dk.supports(tm, (37, 53), torch.float32)   # no alignment needed
    assert not dk.supports(tm, (100, 1024), torch.float64)

    assert dk.select_engine(tm, (100, 1024), torch.float32)[1] \
        == "cuda_d2q9_resident[d2q9,fuse=8]"
    assert dk.select_engine(tm, (520, 520), torch.float32)[1] \
        == "cuda_d2q9_band[d2q9,fuse=2]"
    assert dk.select_engine(tm, (16, 16), torch.float64) == (None, None)
    # the Lattice takes the kernels on the card only
    monkeypatch.delenv("TCLB_FASTPATH", raising=False)
    auto = Lattice(tm, (16, 16), dtype=torch.float32, device="cpu")
    assert auto.engine_name == "eager"
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    off = Lattice(tm, (16, 16), dtype=torch.float32, device="cpu")
    assert off.engine_name == "eager"


def test_family_engines_and_launch_keys():
    """The family runs on the same three kernels, one library per model:
    its engines carry the model in their tag and its launches count
    under ``name[model]``; a model the kernels lack is refused."""
    assert set(dk.LAUNCHES) == {
        dk.launch_key(k, m) for k in dk.KERNELS for m in dk.MODEL_ID}
    assert dk.launch_key("d2q9_step2", "d2q9") == "d2q9_step2"
    for name in dk.FAMILY:
        m = get_model(name)
        assert dk.select_engine(m, (1024, 1024), torch.float32)[1] \
            == f"cuda_d2q9_band[{name},fuse=2]"
        assert dk.launch_key("d2q9_step2", name) in dk.LAUNCHES
    kuper = get_model("d2q9_kuper")
    assert not dk.supports(kuper, (64, 64), torch.float32)
    with pytest.raises(ValueError, match="unsupported"):
        dk.make_band_iterate(kuper, (64, 64))


def test_bound_counts():
    """Bytes and operations of one launch, as chip_smoke.py reports them."""
    tm = get_model("d2q9")
    flags = rich_flags(tm, *SHAPE)
    n = SHAPE[0] * SHAPE[1]
    assert dk.launch_bytes(tm, SHAPE) == (2 * 11 + 3) * 4 * n
    flags = flags.astype(np.int64)

    def count(name):
        t = tm.node_types[name]
        return int(((flags & t.mask) == t.value).sum())

    zou_he = sum(count(n) for n in ("EVelocity", "WPressure", "WVelocity",
                                    "EPressure"))
    assert count("MRT") > 0 and zou_he > 0
    # 267 by hand: rho 8, j 5 + 5, 2 divisions, equilibria 2 x 53,
    # f - feq 9, M rows 3..8 over their nonzeros 13 + 13 + 7 + 7 + 3 + 3,
    # 6 rates, 4 force adds, Minv columns 3..8 onto feq 4 + 4 x 8 + 4 x 10
    assert dk.node_step_flops(tm, flags) == 267 * count("MRT") + 21 * zou_he
