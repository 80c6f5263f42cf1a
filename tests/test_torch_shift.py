"""The storage ladder in the port against the JAX package: the DDF shift
(``tclb_tpu_torch/core/shift.py`` against ``tclb_tpu/core/shift.py``), the
narrowed ``Lattice`` (constructor contract, accessors, the eager engine's
narrowed carry against the JAX package's XLA engine at f64 compute and bf16
storage, bit for bit), checkpoints and ``convert`` across both packages, the
engine selection that keeps bf16 off the kernels without a bf16 rung, and
the refusal to differentiate a narrowed lattice.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu import precision as jax_precision  # noqa: E402
from tclb_tpu.core import shift as jddf  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model, list_models  # noqa: E402
from tclb_tpu_torch import precision  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.core import shift as ddf  # noqa: E402
from tclb_tpu_torch.core.lattice import make_sampled_iterate  # noqa: E402
from tclb_tpu_torch.ops import d2q9_kernels as dk  # noqa: E402
from tclb_tpu_torch.ops import d3q27_kernels as dk3  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic3d_kernels as g3  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402

PORTED = list_models()
BF16 = torch.bfloat16


def _bits(a) -> np.ndarray:
    """The uint16 bits of a bf16 tensor or JAX/numpy bf16 array."""
    if isinstance(a, torch.Tensor):
        return ddf.bf16_bits(a)
    return np.asarray(a).view(np.uint16)


def _cavity(cls=Lattice, n=16, dtype=torch.float32, **kw):
    """The JAX package's test_shift cavity in either package."""
    if cls is Lattice:
        lat = Lattice(get_model("d2q9"), (n, n), dtype=dtype, device="cpu",
                      settings={"nu": 0.05, "Velocity": 0.02}, **kw)
    else:
        lat = JaxLattice(jax_model("d2q9"), (n, n), dtype=dtype,
                         settings={"nu": 0.05, "Velocity": 0.02}, **kw)
    m = lat.model
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[0] = flags[-1] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


# --------------------------------------------------------------------------- #
# core/shift.py against the JAX package's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", PORTED)
def test_storage_shift_matches_reference(name):
    """Every ported model's shift vector, default representation and the
    kernels' float32 shifts, as the JAX package derives them."""
    pm, jm = get_model(name), jax_model(name)
    np.testing.assert_array_equal(ddf.storage_shift(pm),
                                  jddf.storage_shift(jm))
    assert ddf.has_shift(pm) == jddf.has_shift(jm)
    for narrowed in (False, True):
        assert ddf.default_repr(pm, narrowed) == \
            jddf.default_repr(jm, narrowed)
    assert ddf.plane_shifts(pm, "shifted") == jddf.plane_shifts(jm,
                                                                "shifted")
    np.testing.assert_array_equal(ddf.stack_shift(pm, "shifted"),
                                  jddf.stack_shift(jm, "shifted"))
    assert ddf.kernel_shift(pm, "raw") is None
    assert ddf.kernel_shift(pm, "shifted") == tuple(
        float(w) for w in jddf.storage_shift(jm).astype(np.float32))


def test_group_weights_rejects_nonstandard_groups():
    for ei in (np.zeros((9, 3), dtype=np.int64),
               np.ones((9, 3), dtype=np.int64)):
        assert ddf.group_weights(ei) is None
        assert jddf.group_weights(ei) is None
    ei = np.zeros((9, 3), dtype=np.int64)
    ei[1, 0] = 2
    assert ddf.group_weights(ei) is None


@pytest.mark.parametrize("narrowed,asked", [
    (False, "shifted"), (True, "hyperbolic"), (False, "hyperbolic"),
    (True, "shifted")])
def test_resolve_repr_errors_match_reference(narrowed, asked):
    """The same ValueError text as the JAX package's for each refused
    combination, the same answer for the others."""
    pm, jm = get_model("d2q9"), jax_model("d2q9")
    try:
        want = jddf.resolve_repr(jm, narrowed, asked)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ddf.resolve_repr(pm, narrowed, asked)
        assert str(got.value) == str(e)
    else:
        assert ddf.resolve_repr(pm, narrowed, asked) == want


@pytest.mark.parametrize("from_repr,to_repr", [
    ("raw", "shifted"), ("shifted", "raw"), ("shifted", "shifted"),
    ("raw", "raw")])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_convert_fields_host_matches_reference(from_repr, to_repr, dtype):
    m = get_model("d2q9_kuper")
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((m.n_storage, 6, 7)) * 0.3).astype(np.float32)
    shift = ddf.storage_shift(m)
    got = ddf.convert_fields_host(arr, from_repr, to_repr, shift, dtype)
    want = jddf.convert_fields_host(
        arr, from_repr, to_repr, shift,
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, _bits(want))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown storage_repr"):
        ddf.convert_fields_host(arr, "sideways", to_repr, shift, dtype)


def test_raw_seams_are_pure_casts():
    x = torch.tensor([-0.0, 1.5])
    for y in (ddf.widen_plane(x, torch.float32, None),
              ddf.narrow_plane(x, torch.float32, None),
              ddf.widen_stack(x, torch.float32, None),
              ddf.narrow_stack(x, torch.float32, None)):
        assert torch.equal(y.view(torch.int32), x.view(torch.int32))


def test_bf16_bits_cross_numpy():
    """bf16 crosses numpy as its uint16 bits, and reads a JAX bf16 array
    without ml_dtypes on the port's side."""
    a = (np.arange(-8, 8, dtype=np.float32) / 3).astype(ml_dtypes.bfloat16)
    t = ddf.tensor_from_numpy(a)
    assert t.dtype == BF16
    np.testing.assert_array_equal(ddf.bf16_bits(t), a.view(np.uint16))
    np.testing.assert_array_equal(
        ddf.to_float64(a), np.asarray(a, dtype=np.float64))
    u = ddf.tensor_from_numpy(a.view(np.uint16), "bfloat16")
    assert torch.equal(u.view(torch.int16), t.view(torch.int16))


# --------------------------------------------------------------------------- #
# The narrowed Lattice
# --------------------------------------------------------------------------- #


def test_storage_dtype_is_opt_in():
    """tests/test_pallas_generic.py:478-493 in the port: the default
    stores in the compute dtype; an integer or a wider storage dtype is
    refused up front, naming ``storage_dtype``."""
    m = get_model("d2q9_heat")
    lat = Lattice(m, (16, 64), dtype=torch.float32, device="cpu")
    assert lat.storage_dtype == torch.float32 and not lat.narrowed
    assert lat.state.fields.dtype == torch.float32
    assert lat.storage_repr == "raw" and lat.engine_name == "eager"
    for bad in (torch.int8, torch.float64):
        with pytest.raises(ValueError, match="storage_dtype"):
            Lattice(m, (16, 64), dtype=torch.float32, device="cpu",
                    storage_dtype=bad)
    # the JAX package refuses the same two
    for bad in (jnp.int8, jnp.float64):
        with pytest.raises(ValueError, match="storage_dtype"):
            JaxLattice(jax_model("d2q9_heat"), (16, 64), dtype=jnp.float32,
                       storage_dtype=bad)


def test_lattice_repr_resolution():
    assert _cavity().storage_repr == "raw"
    lat = _cavity(storage_dtype=BF16)
    assert lat.storage_repr == "shifted"
    assert lat.state.fields.dtype == BF16
    assert lat.params.settings.dtype == torch.float32
    assert lat.state.globals_.dtype == torch.float32
    assert _cavity(storage_dtype="bfloat16", storage_repr="raw"
                   ).storage_repr == "raw"
    with pytest.raises(ValueError, match="narrowed"):
        _cavity(storage_repr="shifted")
    assert lat.engine_name == "eager[bfloat16/shifted]"


def test_shifted_at_rest_layout_and_accessors():
    """Shifted storage holds deviations; the raw accessors give the same
    physics in both representations, and a density written raw reads
    back raw."""
    raw = _cavity(storage_dtype=BF16, storage_repr="raw")
    sh = _cavity(storage_dtype=BF16, storage_repr="shifted")
    dens = ddf.storage_shift(raw.model) > 0
    assert float(raw.state.fields[dens].float().abs().max()) > 0.1
    assert float(sh.state.fields[dens].float().abs().max()) < 0.1
    np.testing.assert_allclose(raw.fields_raw(), sh.fields_raw(), atol=1e-2)
    np.testing.assert_allclose(sh.get_quantity("Rho").numpy(), 1.0,
                               atol=5e-2)
    np.testing.assert_allclose(sh.get_density("f[0]").numpy(),
                               raw.get_density("f[0]").numpy(), atol=1e-2)
    plane = np.full((16, 16), 0.45)
    sh.set_density("f[0]", plane)
    np.testing.assert_allclose(sh.get_density("f[0]").numpy(), 0.45,
                               atol=2e-3)
    assert float(sh.state.fields[0].float().abs().max()) < 0.01


@pytest.mark.parametrize("storage_repr", ["raw", "shifted"])
@pytest.mark.parametrize("case", ["cavity", "kuper_drop"])
def test_eager_f64_bf16_matches_xla(case, storage_repr):
    """The narrowed eager engine at f64 compute and bf16 storage against
    the JAX package's XLA engine: the harness cases at 32x32, 100 steps,
    the bf16 fields bit for bit."""
    model, shape, settings, flags, zonal = jax_precision.build_case(case,
                                                                    32)
    a = JaxLattice(model, shape, dtype=jnp.float64, settings=settings,
                   storage_dtype=jnp.bfloat16, storage_repr=storage_repr)
    b = Lattice(get_model(model.name), shape, dtype=torch.float64,
                settings=settings, device="cpu", storage_dtype=BF16,
                storage_repr=storage_repr)
    for lat in (a, b):
        for (sname, zone), val in zonal.items():
            lat.set_setting(sname, val, zone=zone)
        lat.set_flags(flags)
        lat.init()
    np.testing.assert_array_equal(_bits(b.state.fields), _bits(
        a.state.fields))
    a.iterate(100)
    b.iterate(100)
    assert b.state.fields.dtype == BF16 and b.eager_steps == 100
    np.testing.assert_array_equal(_bits(b.state.fields),
                                  _bits(a.state.fields))
    np.testing.assert_array_equal(b.fields_raw(), a.fields_raw())


def test_sampled_iterate_narrows_once_a_step():
    """<Sample> on a narrowed lattice: the steps are the narrowed eager
    steps and the probes read the stored state widened with its shift."""
    lat = _cavity(storage_dtype=BF16)
    ref = _cavity(storage_dtype=BF16)
    it = make_sampled_iterate(lat.model, np.array([[5, 5], [8, 9]]),
                              ["U"], BF16, lat._shift_block)
    state, samples = it(lat.state, lat.params, 3)
    ref.iterate(3)
    assert torch.equal(state.fields, ref.state.fields)
    u = ref.get_quantity("U")
    assert torch.equal(samples[-1], torch.stack([u[:, 5, 5], u[:, 8, 9]]))


# --------------------------------------------------------------------------- #
# Checkpoints and convert across representations and packages
# --------------------------------------------------------------------------- #


def test_same_repr_restore_is_bit_exact_at_rest(tmp_path):
    sh = _cavity(storage_dtype=BF16)
    sh.iterate(8)
    sh.save(str(tmp_path / "ck.npz"))
    with np.load(tmp_path / "ck.npz") as d:
        assert str(d["storage_dtype"]) == "bfloat16"
        assert str(d["storage_repr"]) == "shifted"
        assert d["fields"].dtype == np.uint16
    sh2 = _cavity(storage_dtype=BF16)
    sh2.load(str(tmp_path / "ck.npz"))
    assert torch.equal(sh2.state.fields.view(torch.int16),
                       sh.state.fields.view(torch.int16))
    sh.iterate(8)
    sh2.iterate(8)
    assert torch.equal(sh2.state.fields.view(torch.int16),
                       sh.state.fields.view(torch.int16))


def test_round_trip_through_raw_f32(tmp_path):
    """tests/test_shift.py:177-222's state (the 16x16 cavity after 12
    steps): shifted bf16 -> raw f32 within 1e-6, and back to shifted bf16
    bit for bit."""
    sh = _cavity(storage_dtype=BF16)
    sh.iterate(12)
    sh.save(str(tmp_path / "sh.npz"))
    wide = _cavity()
    wide.load(str(tmp_path / "sh.npz"))
    assert wide.state.iteration == 12
    np.testing.assert_allclose(wide.fields_raw(), sh.fields_raw(), atol=1e-6)
    wide.save(str(tmp_path / "wide.npz"))
    sh2 = _cavity(storage_dtype=BF16)
    sh2.load(str(tmp_path / "wide.npz"))
    assert torch.equal(sh2.state.fields.view(torch.int16),
                       sh.state.fields.view(torch.int16))


@pytest.mark.parametrize("storage_repr", ["raw", "shifted"])
def test_checkpoints_cross_packages_bit_exact(tmp_path, storage_repr):
    """A bf16 checkpoint of either package restores in the other bit for
    bit at rest, and both go on computing the same bits."""
    a = _cavity(JaxLattice, dtype=jnp.float32, storage_dtype=jnp.bfloat16,
                storage_repr=storage_repr)
    b = _cavity(storage_dtype=BF16, storage_repr=storage_repr)
    a.iterate(6)
    a.save(str(tmp_path / "jax.npz"))
    b.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(_bits(b.state.fields),
                                  _bits(a.state.fields))
    assert b.state.iteration == 6
    b.iterate(5)
    b.save(str(tmp_path / "port.npz"))
    c = _cavity(JaxLattice, dtype=jnp.float32, storage_dtype=jnp.bfloat16,
                storage_repr=storage_repr)
    c.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(_bits(c.state.fields),
                                  _bits(b.state.fields))
    assert int(c.state.iteration) == 11


def test_convert_carries_bf16_both_ways():
    a = _cavity(JaxLattice, dtype=jnp.float32, storage_dtype=jnp.bfloat16)
    a.iterate(4)
    state, params = state_from_numpy(
        get_model("d2q9"), np.asarray(a.state.fields),
        np.asarray(a.state.flags), np.asarray(a.state.globals_),
        a.state.iteration, np.asarray(a.params.settings),
        np.asarray(a.params.zone_table), device="cpu")
    assert state.fields.dtype == BF16
    assert params.settings.dtype == torch.float32
    np.testing.assert_array_equal(_bits(state.fields),
                                  _bits(a.state.fields))
    b = _cavity(storage_dtype=BF16)
    b.set_state(state, params)
    out = state_to_numpy(b.state, b.params)
    assert out["fields"].dtype == np.uint16
    assert out["storage_dtype"] == "bfloat16"
    np.testing.assert_array_equal(out["fields"], _bits(a.state.fields))
    back = out["fields"].view(ml_dtypes.bfloat16)
    a.iterate(3)
    b.iterate(3)
    np.testing.assert_array_equal(_bits(b.state.fields),
                                  _bits(a.state.fields))
    assert back.dtype == np.dtype(ml_dtypes.bfloat16)


# --------------------------------------------------------------------------- #
# Engine selection: bf16 only where a kernel has the rung
# --------------------------------------------------------------------------- #


def test_selection_rejects_bf16_without_a_rung(capsys):
    """K1/K2 reject bf16 (as the JAX package's pallas_d2q9 does), and so
    do K6, the series flavours and the kernel adjoint; K4/K5 and K3 take
    it and name it in the tag; a rejected lattice runs eager with the
    storage in its tag."""
    f32 = torch.float32
    d2q9, kuper = get_model("d2q9"), get_model("d2q9_kuper")
    for repr_ in ddf.STORAGE_REPRS:
        kw = dict(storage_dtype=BF16, storage_repr=repr_)
        assert dk.select_engine(d2q9, (100, 1024), f32, **kw) == (None,
                                                                   None)
        assert g3.select_engine(get_model("d3q19_adj"), (8, 16, 32), f32,
                                **kw) == (None, None)
        assert gk.select_engine(d2q9, (96, 512), f32, series=True,
                                **kw) == (None, None)
        assert gk.select_engine(d2q9, (1024, 1024), f32, **kw)[1] == \
            f"cuda_generic_band[d2q9,fuse=1,bfloat16/{repr_}]"
        assert gk.select_engine(kuper, (64, 64), f32, **kw)[1] == \
            f"cuda_generic_resident[d2q9_kuper,fuse=N,bfloat16/{repr_}]"
        assert dk3.select_engine(get_model("d3q19"), (8, 8, 32), f32,
                                 **kw)[1] == \
            f"cuda_d3q27_band[d3q19,fuse=2,bfloat16/{repr_}]"
    assert not ak.supports_diff(get_model("d2q9_heat_adj"), (32, 64), f32,
                                BF16)
    assert ak.supports_diff(get_model("d2q9_heat_adj"), (32, 64), f32)
    # f32 storage: the tags and engines of before
    assert dk.select_engine(d2q9, (100, 1024), f32,
                            storage_dtype=f32)[1] == \
        "cuda_d2q9_resident[d2q9,fuse=8]"
    assert gk.select_engine(kuper, (1024, 1024), f32)[1] == \
        "cuda_generic_band[d2q9_kuper,fuse=1]"
    lat = Lattice(get_model("d3q19_adj"), (4, 8, 8), device="cpu",
                  storage_dtype=BF16)
    capsys.readouterr()
    assert lat.engine_name == "eager[bfloat16/shifted]"
    assert "engine: eager[bfloat16/shifted]" in capsys.readouterr().out


def test_gradients_of_a_narrowed_lattice_are_refused():
    """The JAX package has no adjoint of a narrowed lattice: the port
    refuses one rather than differentiating at another precision."""
    from tclb_tpu_torch.control.opt_handlers import _full_width
    _full_width(_cavity())
    with pytest.raises(NotImplementedError, match="queue 2"):
        _full_width(_cavity(storage_dtype=BF16))


def test_error_bounds_are_the_references():
    assert precision.ERROR_BOUNDS == jax_precision.ERROR_BOUNDS
    assert precision.CASE_NAMES == jax_precision.CASE_NAMES
    for case in precision.CASE_NAMES:
        pm, pshape, ps, pflags, pz = precision.build_case(case, 24)
        jm, jshape, js, jflags, jz = jax_precision.build_case(case, 24)
        assert (pm.name, pshape, ps, pz) == (jm.name, jshape, js, jz)
        np.testing.assert_array_equal(pflags, jflags)


@pytest.mark.parametrize("name", ["d3q27_cumulant", "d3q19"])
def test_eager_f64_bf16_forced_channel_matches_xla(name):
    """The narrowed eager engine in 3D: a forced channel (3d_channel.xml's
    nu and force, cut to 8x12x32) at f64 compute and shifted bf16 storage
    against the JAX package's XLA engine, 20 steps, bit for bit.  The
    force's per-step increment is below half a bf16 step of the stored
    deviations once the flow moves, in both packages alike."""
    from torch_cases import channel3d_flags
    shape = (8, 12, 32)
    force = "ForceX" if name == "d3q27_cumulant" else "GravitationX"
    settings = {"nu": 0.01, force: 1e-5}
    a = JaxLattice(jax_model(name), shape, dtype=jnp.float64,
                   settings=settings, storage_dtype=jnp.bfloat16)
    b = Lattice(get_model(name), shape, dtype=torch.float64,
                settings=settings, device="cpu", storage_dtype=BF16)
    flags = channel3d_flags(b.model, *shape)
    for lat in (a, b):
        lat.set_flags(flags)
        lat.init()
        lat.iterate(20)
    assert b.storage_repr == "shifted"
    np.testing.assert_array_equal(_bits(b.state.fields),
                                  _bits(a.state.fields))
