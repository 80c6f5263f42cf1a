"""The d2q9 family in the port (``d2q9_SRT``, ``d2q9_les``, ``d2q9_inc``,
``d2q9_cumulant``, ``d2q9_new``) against the JAX package: the eager step
against the XLA step at f64 on a state that paints every node type each
model reads, the plain versions of the three d2q9 kernels against
``pallas_d2q9``'s family kernels in interpret mode, the analytic Poiseuille
profile, a ``.npz`` state carried across, the registry and the kernels'
constants.  The CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_cuda.py``."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import pathlib  # noqa: E402
import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_d2q9  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.models import d2q9_new  # noqa: E402
from tclb_tpu_torch.ops import cumulant  # noqa: E402
from tclb_tpu_torch.ops import d2q9_kernels as dk  # noqa: E402
from torch_cases import (FAMILY_MODELS, FAMILY_SHAPE,  # noqa: E402
                         family_settings, paint_rich_family,
                         rich_flags_family)

GOLDEN = dict(rtol=1e-10, atol=1e-12)      # tests/test_golden.py:30
# the reference's own family-kernel tolerance (tests/test_pallas.py:154-155)
KERNEL_TOL = dict(rtol=3e-5, atol=3e-6)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
CSRC = pathlib.Path(dk.__file__).resolve().parents[1] / "csrc" / "d2q9.cu"


def lattice_pair(name, seed, prec="f64"):
    """The same rich state of model ``name`` in both packages."""
    jdt, tdt = DTYPES[prec]
    jm, tm = jax_model(name), get_model(name)
    a = JaxLattice(jm, FAMILY_SHAPE, dtype=jdt, settings=family_settings(jm))
    b = Lattice(tm, FAMILY_SHAPE, dtype=tdt, settings=family_settings(tm),
                device="cpu")
    return paint_rich_family(a, seed), paint_rich_family(b, seed)


# --------------------------------------------------------------------------- #
# registry and eager engine against the reference
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", FAMILY_MODELS)
def test_registry_matches(name):
    """Storage, settings, globals, node-type packing and quantities are
    the reference's, so flags and states cross without translation."""
    j, t = jax_model(name), get_model(name)
    assert t.storage_names == j.storage_names and t.n_storage == 9
    np.testing.assert_array_equal(t.ei, j.ei)
    assert [(s.name, s.zonal, s.default) for s in t.settings] == \
        [(s.name, s.zonal, s.default) for s in j.settings]
    np.testing.assert_array_equal(t.settings_vector(family_settings(t)),
                                  j.settings_vector(family_settings(j)))
    assert {n: (x.group, x.value, x.mask) for n, x in t.node_types.items()} \
        == {n: (x.group, x.value, x.mask) for n, x in j.node_types.items()}
    assert t.group_masks == j.group_masks
    assert [(g.name, g.op) for g in t.globals_] == \
        [(g.name, g.op) for g in j.globals_]
    assert [q.name for q in t.quantities] == [q.name for q in j.quantities]
    assert t.fingerprint == j.fingerprint


@pytest.mark.parametrize("name", FAMILY_MODELS)
def test_eager_matches_xla(name, monkeypatch):
    """20 steps at f64 on the rich state: fields, globals and every
    quantity at the golden tolerance."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    a, b = lattice_pair(name, 1)
    np.testing.assert_array_equal(b.state.fields.numpy(),
                                  np.asarray(a.state.fields))
    a.iterate(20)
    b.iterate(20)
    assert b.engine_name == "eager"
    assert b.state.iteration == int(a.state.iteration) == 20
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), **GOLDEN)
    ga, gb = a.get_globals(), b.get_globals()
    assert list(ga) == list(gb)
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], **GOLDEN, err_msg=k)
    if name != "d2q9_new":      # d2q9_new declares globals it never sums
        assert all(abs(v) > 0 for v in gb.values())
    # the quantities on the same fields: d2q9_new's A is a ratio of two
    # differences of nearly equal moments, which turns the fields' last-bit
    # differences into ~1e-9 relative ones
    b.set_density_planes({n: np.array(a.get_density(n))
                          for n in b.model.storage_names})
    for q in a.model.quantities:
        np.testing.assert_allclose(b.get_quantity(q.name).numpy(),
                                   np.asarray(a.get_quantity(q.name)),
                                   **GOLDEN, err_msg=q.name)


def _poiseuille_flags(m, shape):
    """tests/test_models.py's channel: walls on the first axis' extremes,
    BGK collision elsewhere."""
    flags = np.full(shape, m.flag_for("BGK"), dtype=np.uint16)
    flags[0] = flags[-1] = m.flag_for("Wall")
    return flags


@pytest.mark.parametrize("name", ["d2q9_SRT", "d2q9_cumulant", "d2q9_inc"])
def test_poiseuille_profile(name):
    """tests/test_models.py:32-49, 86-88 on the port's eager engine: the
    body-force-driven channel's mean ux profile within 2% of
    ``g / (2 nu) (y - 0.5)(h + 0.5 - y)``."""
    shape, g, nu = (18, 4), 1e-5, 0.1
    m = get_model(name)
    lat = Lattice(m, shape, dtype=torch.float64, device="cpu",
                  settings={"nu": nu, "GravitationX": g})
    lat.set_flags(_poiseuille_flags(m, shape))
    lat.init()
    lat.iterate(3000)
    prof = lat.get_quantity("U")[0].numpy().reshape(shape[0], -1).mean(1)
    h = shape[0] - 2
    y = np.arange(1, shape[0] - 1, dtype=np.float64)
    ana = g / (2 * nu) * (y - 0.5) * (h + 0.5 - y)
    np.testing.assert_allclose(prof[1:-1], ana, rtol=0.02)


@pytest.mark.parametrize("name", FAMILY_MODELS)
def test_jax_state_loads_and_steps(name, tmp_path, monkeypatch):
    """A ``.npz`` the JAX package saved (the model's own plane order)
    loads into the port bit for bit, and one step matches."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    a, _ = lattice_pair(name, 2)
    a.iterate(5)
    a.save(str(tmp_path / "s"))
    b = Lattice(get_model(name), FAMILY_SHAPE, dtype=torch.float64,
                device="cpu")
    b.load(str(tmp_path / "s"))
    assert b.state.iteration == 5
    np.testing.assert_array_equal(b.state.fields.numpy(),
                                  np.asarray(a.state.fields))
    np.testing.assert_array_equal(b.flags_numpy(), np.asarray(a.state.flags))
    a.iterate(1)
    b.iterate(1)
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), **GOLDEN)


# --------------------------------------------------------------------------- #
# plain versions of the kernels against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", FAMILY_MODELS)
def test_plain_resident_matches_pallas_resident(name):
    """niter = 11: one 8-step launch, then three single steps."""
    a, b = lattice_pair(name, 3, "f32")
    want = pallas_d2q9.make_resident_iterate(
        a.model, FAMILY_SHAPE, jnp.float32, interpret=True)(
            a.state, a.params, 11)
    got = dk.make_resident_iterate(b.model, FAMILY_SHAPE)(
        b.state, b.params, 11)
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **KERNEL_TOL)
    assert got.iteration == 11 and not got.globals_.any()


@pytest.mark.parametrize("name", FAMILY_MODELS)
@pytest.mark.parametrize("fuse,niter", [(1, 3), (2, 5)])
def test_plain_band_matches_pallas_band(name, fuse, niter):
    """fuse=2 with an odd niter runs two fused pairs and one single step."""
    a, b = lattice_pair(name, 4, "f32")
    want = pallas_d2q9.make_pallas_iterate(
        a.model, FAMILY_SHAPE, jnp.float32, interpret=True, fuse=fuse)(
            a.state, a.params, niter)
    got = dk.make_band_iterate(b.model, FAMILY_SHAPE, fuse=fuse)(
        b.state, b.params, niter)
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **KERNEL_TOL)
    assert got.iteration == niter and not got.globals_.any()


@pytest.mark.parametrize("name", FAMILY_MODELS)
def test_cpu_tensor_takes_plain_version_without_counting(name):
    _, b = lattice_pair(name, 5, "f32")
    f, flags, vel, den, args = dk.kernel_inputs(b.model, b.state, b.params)
    dk.reset_launches()
    for kernel, (fn, n) in dk.WRAPPERS.items():
        got = fn(f, flags, vel, den, args)
        assert torch.equal(got, dk.plain_steps(f, flags, vel, den, args, n))
    assert not any(dk.LAUNCHES.values())


# --------------------------------------------------------------------------- #
# engine choice and the kernels' constants
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", FAMILY_MODELS)
def test_engine_choice(name):
    m = get_model(name)
    assert dk.supports(m, (37, 53), torch.float32)
    assert not dk.supports(m, (37, 53), torch.float64)
    assert dk.select_engine(m, (128, 1024), torch.float32)[1] \
        == f"cuda_d2q9_resident[{name},fuse=8]"
    assert dk.select_engine(m, (1024, 1024), torch.float32)[1] \
        == f"cuda_d2q9_band[{name},fuse=2]"
    assert dk.launch_key("d2q9_step", name) == f"d2q9_step[{name}]"
    assert dk.launch_bytes(m, (1024, 1024)) == (2 * 9 + 3) * 4 * 1024 ** 2


def test_step_args():
    """Each model's constants: its velocity order (d2q9_cumulant's is the
    tensor order), its cases (a type it lacks never matches), its
    settings, and d2q9_new's density from the zonal Pressure."""
    for name in FAMILY_MODELS:
        m = get_model(name)
        a = dk.step_args(m, (8, 8), m.settings_vector(family_settings(m)))
        E = m.ei[:9, :2]
        assert (a.ex, a.ey) == (tuple(E[:, 0]), tuple(E[:, 1]))
        for k in range(9):
            assert (a.ex[a.opp[k]], a.ey[a.opp[k]]) == (-a.ex[k], -a.ey[k])
        sym = dict(zip(dk.CASES, a.cases))["TopSymmetry"]
        assert (sym == dk.NEVER) == ("TopSymmetry" not in m.node_types)
        assert a.omega == pytest.approx(1 / (3 * 0.05 + 0.5))
        assert a.coll_mask == m.group_masks["COLLISION"]
    cum = get_model("d2q9_cumulant")
    assert dk.step_args(cum, (8, 8), cum.settings_vector()).ex[:3] \
        == (-1, -1, -1)
    new = get_model("d2q9_new")
    lat = Lattice(new, (6, 8), device="cpu", dtype=torch.float32,
                  settings={"Pressure": 0.01})
    lat.set_flags(rich_flags_family(new, 6, 8))
    *_, den, a = dk.kernel_inputs(new, lat.state, lat.params)
    np.testing.assert_allclose(den.numpy(), 1.03, rtol=1e-6)
    assert a.smag_type == (new.node_types["Smagorinsky"].mask,
                           new.node_types["Smagorinsky"].value)


def test_compiled_constants_match_the_plain_versions():
    """csrc/d2q9.cu compiles in d2q9_cumulant's inverse Vandermonde and
    d2q9_new's monomial basis (its poly_p/poly_q); both must be what the
    plain versions multiply by."""
    np.testing.assert_array_equal(
        cumulant.T_INV, [[0, -0.5, 0.5], [1, 0, -1], [0, 0.5, 0.5]])
    src = CSRC.read_text()
    assert "(0, -1/2, 1/2), (1, 0, -1), (0, 1/2, 1/2)" in src

    def table(fn):
        body = re.search(rf"constexpr int {fn}\(int r\) {{\s*constexpr "
                         rf"int \w\[9\] = {{([^}}]*)}}", src).group(1)
        return [int(v) for v in body.split(",")]

    assert list(zip(table("poly_p"), table("poly_q"))) \
        == d2q9_new.POLYS


def test_bound_counts():
    """Operations of one step per model, as chip_smoke.py reports them:
    the per-node figures of node_step_flops' docstring, by hand."""
    counts = {"d2q9_SRT": 173, "d2q9_les": 208, "d2q9_inc": 197,
              "d2q9_cumulant": 118}
    for name in FAMILY_MODELS:
        m = get_model(name)
        flags = rich_flags_family(m, *FAMILY_SHAPE).astype(np.int64)

        def count(t, within=None):
            t = m.node_types[t]
            hit = (flags & t.mask) == t.value
            return int((hit & within).sum() if within is not None
                       else hit.sum())

        faces = sum(count(t) for t in ("EVelocity", "WPressure",
                                       "WVelocity", "EPressure"))
        assert faces > 0
        got = dk.node_step_flops(m, flags)
        if name == "d2q9_new":
            mrt = (flags & m.node_types["MRT"].mask) \
                == m.node_types["MRT"].value
            assert count("Smagorinsky", mrt) > 0 and count("Stab", mrt) > 0
            assert got == 212 * int(mrt.sum()) \
                + 15 * count("Smagorinsky", mrt) \
                + 16 * count("Stab", mrt) + 21 * faces
        else:
            coll = int(((flags & m.group_masks["COLLISION"]) != 0).sum())
            assert got == counts[name] * coll + 19 * faces
