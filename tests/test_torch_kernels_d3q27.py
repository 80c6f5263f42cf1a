"""The z-slab collide-stream kernels of
``tclb_tpu_torch/ops/d3q27_kernels.py``: d3q27_cumulant, and the same
kernels built for d3q27_BGK, d3q27_BGK_galcor, d3q19 and d3q19_les.

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

import dataclasses  # noqa: E402

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
from torch_cases import (D3Q_FAMILY, RICH3D_SETTINGS, SHAPE3D,  # noqa: E402
                         d3q_family_settings, paint_rich_3d, paint_rich_d3q,
                         rich_flags_3d, rich_flags_d3q)

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
    assert not any(dk.LAUNCHES.values())


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
    assert dk.step2_planes((48, 48, 256), 132, 8) == 6
    for shape, slots in (((12, 8, 64), 132), ((7, 9, 40), 4),
                         ((48, 48, 256), 264)):
        zc = dk.step2_planes(shape, slots, 8)
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


# --------------------------------------------------------------------------- #
# the rest of the z-slab family (d3q27_BGK, d3q27_BGK_galcor, d3q19,
# d3q19_les) on the same kernels
# --------------------------------------------------------------------------- #

FAMILY_CASES = [("d3q27_BGK", {}), ("d3q27_BGK_galcor", {}),
                ("d3q19", {"S_high": 1.3}), ("d3q19_les", {"Smag": 0.17})]


def family_pair(name, seed, **extra):
    """The same f32 rich state of a family model in both packages."""
    jm, tm = jax_model(name), get_model(name)
    a = JaxLattice(jm, SHAPE3D, dtype=jnp.float32,
                   settings=d3q_family_settings(jm, **extra))
    b = Lattice(tm, SHAPE3D, dtype=torch.float32,
                settings=d3q_family_settings(tm, **extra), device="cpu")
    return paint_rich_d3q(a, seed), paint_rich_d3q(b, seed)


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("name,extra", FAMILY_CASES)
def test_family_plain_band_matches_pallas_band(name, extra, fuse):
    """niter = 5 through ``pallas_d3q.make_pallas_iterate`` in interpret
    mode (tests/test_pallas3d.py:70-136) and the port's plain band: at
    fuse=2 two fused launches and one single step, at fuse=1 five single
    steps; every node type the model reads, two zones, gravity."""
    a, b = family_pair(name, 2, **extra)
    it = pallas_d3q.make_pallas_iterate(a.model, SHAPE3D, jnp.float32,
                                        interpret=True, fuse=fuse)
    want = it(jax.tree.map(jnp.copy, a.state), a.params, 5)
    got = dk.make_band_iterate(b.model, SHAPE3D, fuse=fuse)(
        b.state, b.params, 5)
    _assert_fields(got.fields, want.fields)
    assert got.iteration == int(want.iteration) == 5
    assert not got.globals_.any()


@pytest.mark.parametrize("name", D3Q_FAMILY)
def test_family_cpu_tensor_takes_plain_version_without_counting(name):
    _, b = family_pair(name, 4)
    f, flags, ztab, args = dk.kernel_inputs(b.model, b.state, b.params)
    assert ztab.shape == (2, b.model.zone_max)
    dk.reset_launches()
    for kernel, (fn, n) in dk.WRAPPERS.items():
        got = fn(f, flags, ztab, args)
        assert torch.equal(got, dk.plain_steps(f, flags, ztab, args, n))
    assert not any(dk.LAUNCHES.values())


@pytest.mark.parametrize("name", D3Q_FAMILY)
def test_family_engine_choice(name):
    """Each model takes the band engine at f32 under its own tag and
    launch keys, none at f64; d3q19 now lands on the z-slab kernels
    before the generic 3D engine, d3q19_adj stays on the generic one."""
    from tclb_tpu_torch.ops import generic3d_kernels
    m = get_model(name)
    assert dk.supports(m, (48, 48, 256), torch.float32)
    assert dk.supports(m, (7, 9, 40), torch.float32)
    assert not dk.supports(m, (48, 48, 256), torch.float64)
    assert dk.select_engine(m, (48, 48, 256), torch.float32)[1] \
        == f"cuda_d3q27_band[{name},fuse=2]"
    assert dk.select_engine(m, (8, 8, 8), torch.float64) == (None, None)
    for kernel in dk.KERNELS:
        assert dk.launch_key(kernel, name) == f"{kernel}[{name}]"
        assert dk.launch_key(kernel, name) in dk.LAUNCHES
    assert generic3d_kernels.select_engine(
        m, (48, 48, 256), torch.float32) == (None, None)
    adj = get_model("d3q19_adj")
    assert not dk.supports(adj, (32, 64, 256), torch.float32)
    assert dk.select_engine(adj, (32, 64, 256), torch.float32) == \
        (None, None)
    assert generic3d_kernels.select_engine(
        adj, (32, 64, 256), torch.float32)[1] \
        == "cuda_generic3d_band[d3q19_adj,fuse=1]"
    with pytest.raises(ValueError, match="storage"):
        dk.check_layout(adj)


def test_family_bound_counts():
    """Bytes per node and the operations of one step, as chip_smoke.py
    reports them: 27 planes in and out plus the flag (220 B) for the BGK
    models, 19 (156 B) for d3q19 and d3q19_les; a d3q19 face by hand."""
    for name in D3Q_FAMILY:
        m = get_model(name)
        per_node = 220 if name.startswith("d3q27") else 156
        n = int(np.prod(SHAPE3D))
        assert dk.launch_bytes(m, SHAPE3D) == per_node * n \
            + 2 * m.zone_max * 4
    # a d3q19 face: tangential and outgoing sums 8 + 4, rho 4, rho un and
    # 5 normal terms, per tangential axis 5 + 1 + 2 x 2, the 5 bounce-back
    # adds -- 47
    for axis in range(3):
        assert dk._nebb_flops(axis, model="d3q19") == 47
        assert dk._nebb_flops(axis, model="d3q27_BGK") == 75
    # a collision node by hand.  d3q27_BGK: rho 26, j 3 x 17, u 3, two
    # equilibria of 170 (|u|^2 5, 1 - 1.5|u|^2 2, four w rho, 26 moving
    # populations of e.u (28 in all) and 5, the rest 1), u + g 3, BGK 81,
    # the force difference 54 -- 558; galcor adds 6 a moving population to
    # each equilibrium (312).  d3q19_les: rho 18, j 3 x 9, u 3, two
    # equilibria of 113, u + g 3, the rate 76 (f - feq 18, the six flux
    # sums 36, |Pi|^2 14, the rate 8), BGK 57, the force 38 -- 448.
    # d3q19: the same rho, j, u, equilibria and u + g (277), f - feq 19,
    # the stress moments 120 and their projection 119 over the rows'
    # nonzeros, the keep factors 3, kh fneq + d back 57, + feq2 19 -- 614
    counts = {name: dk.collision_flops(name) for name in D3Q_FAMILY}
    assert counts == {"d3q27_BGK": 558, "d3q27_BGK_galcor": 558 + 312,
                      "d3q19": 614, "d3q19_les": 448}
    for name in D3Q_FAMILY:
        m = get_model(name)
        flags = rich_flags_d3q(m, *SHAPE3D).astype(np.int64)

        def count(t):
            nt = m.node_types[t]
            return int(((flags & nt.mask) == nt.value).sum())

        coll = int(((flags & m.group_masks["COLLISION"]) != 0).sum())
        faces = sum(count(f + k) for f in "WE"
                    for k in ("Velocity", "Pressure"))
        assert dk.node_step_flops(m, flags) == (
            counts[name] * coll
            + dk._nebb_flops(0, model=name) * faces)


def test_family_step_args():
    """The constants each model's build takes: its cases (the cumulant's
    faces never match), gravity alone as the force, d3q19's S_high and
    stress rows, d3q19_les's Smag."""
    from tclb_tpu_torch.models import d3q19
    for name in D3Q_FAMILY:
        m = get_model(name)
        a = dk.step_args(m, SHAPE3D, m.settings_vector(
            d3q_family_settings(m)))
        c = a.c_struct()
        assert len(a.cases) == len(dk.CASES[name]) == 8
        assert (c.case_mask[8], c.case_val[8]) == dk.NEVER
        assert list(c.force) == pytest.approx([2e-5, -1e-5, 5e-6])
        assert c.omega == pytest.approx(1 / (3 * 0.05 + 0.5))
        assert c.s_high == pytest.approx(1.3 if name == "d3q19" else 0.0)
        assert c.smag == pytest.approx(0.17 if name == "d3q19_les" else 0.0)
    stress, back = dk.stress_rows()
    np.testing.assert_allclose(stress @ back, np.eye(6), atol=1e-12)
    np.testing.assert_array_equal(stress, d3q19.M[4:10])


# --------------------------------------------------------------------------- #
# the storage ladder: the plain versions of the bf16 flavours
# --------------------------------------------------------------------------- #

from tclb_tpu_torch.core import shift as ddf  # noqa: E402
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402

BF16_SHAPE = (8, 8, 32)


def bf16_lattice(name, storage_repr, seed=5):
    m = get_model(name)
    settings = RICH3D_SETTINGS if name == NAME else d3q_family_settings(m)
    lat = Lattice(m, BF16_SHAPE, dtype=torch.float32, settings=settings,
                  device="cpu", storage_dtype=torch.bfloat16,
                  storage_repr=storage_repr)
    return (paint_rich_3d if name == NAME else paint_rich_d3q)(lat, seed)


@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name", (NAME,) + D3Q_FAMILY)
def test_bf16_plain_kernels_equal_narrowed_eager(name, storage_repr):
    """The plain bf16 d3q27_step is one narrowed eager step, and
    d3q27_step2 two f32 eager steps between one widen and one narrow (the
    kernel's cadence: its ring of step-1 planes stays f32), bit for bit;
    the cumulant's SynthT planes pass through; no launch is counted."""
    b = bf16_lattice(name, storage_repr)
    m = b.model
    sb = ddf.stack_shift(m, storage_repr)
    f, flags, ztab, args = dk.kernel_inputs(
        m, b.state, b.params, ddf.kernel_shift(m, storage_repr))
    assert (args.c_shift is None) == (storage_repr == "raw")
    dk.reset_launches()
    one = make_iterate(m, storage_dtype=torch.bfloat16,
                       storage_shift=sb)(b.state, b.params, 1).fields
    wide = dataclasses.replace(b.state, fields=ddf.widen_stack(
        f, torch.float32, sb))
    two = ddf.narrow_stack(make_iterate(m)(wide, b.params, 2).fields,
                           torch.bfloat16, sb)
    for (fn, n), want in zip(dk.WRAPPERS.values(), (one, two)):
        got = fn(f, flags, ztab, args)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        if name == NAME:
            assert torch.equal(got[27:30], f[27:30])
    assert not any(dk.LAUNCHES.values())


def test_bf16_bounds_and_shifts():
    """A bf16 node moves 2 B a plane each way plus the flag: the cumulant
    140 B, the BGK models 112 B, d3q19 and d3q19_les 80 B; the shifts the
    kernels take (core/shift.py:kernel_shift) are f32 of each population's
    weight in the velocity order csrc/d3q27.cu builds, 0 for SynthT and
    the averages."""
    n = int(np.prod(SHAPE3D))
    for name, per_node in ((NAME, 140), ("d3q27_BGK", 112),
                           ("d3q27_BGK_galcor", 112), ("d3q19", 80),
                           ("d3q19_les", 80)):
        m = get_model(name)
        assert dk.launch_bytes(m, SHAPE3D, itemsize=2) == per_node * n \
            + len(dk.ZONAL[name]) * m.zone_max * 4
        E, W, _ = dk._SETS[name]
        want = np.zeros(m.n_storage, dtype=np.float32)
        want[:len(W)] = np.asarray(W, dtype=np.float64)
        assert ddf.kernel_shift(m, "shifted") == tuple(
            float(w) for w in want)
        assert dk.supports(m, SHAPE3D, torch.float32,
                           storage_dtype=torch.bfloat16)
        assert not dk.supports(m, SHAPE3D, torch.float32,
                               storage_dtype=torch.float16)
