"""The generic 2D kernels of ``tclb_tpu_torch/ops/generic_kernels.py``.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's generic Pallas engines in interpret mode (the
band engine with its in-kernel globals, and the resident engine composed
with it) and against its XLA engine, on a walled d2q9_kuper state that
paints every node type.  Also here: the stage plan against the JAX
package's, the engine choice and its ``full_globals`` contract through
``Lattice.iterate``, the bound counts, the device header against the
registry, and the build digest over included headers.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import dataclasses  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_iterate as jax_make_iterate  # noqa: E402,E501
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.ops import pallas_generic  # noqa: E402
from tclb_tpu.ops.lbm import present_types as jax_present  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.ops import _cuda_build, lbm  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (KUPER_SETTINGS, KUPER_SHAPE,  # noqa: E402
                         RICH_SETTINGS, paint_rich, paint_rich_kuper,
                         rich_flags, rich_flags_kuper)

NAME = "d2q9_kuper"
# f32 engines against each other: tests/test_fastpath.py's tolerances
FIELDS_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
NITER = 5


def lattice_pair(seed):
    """The same f32 state in both packages."""
    a = JaxLattice(jax_model(NAME), KUPER_SHAPE, dtype=jnp.float32,
                   settings=KUPER_SETTINGS)
    b = Lattice(get_model(NAME), KUPER_SHAPE, dtype=torch.float32,
                settings=KUPER_SETTINGS, device="cpu")
    return paint_rich_kuper(a, seed), paint_rich_kuper(b, seed)


def _copy(state):
    # the JAX engines donate their input state
    return jax.tree.map(jnp.copy, state)


def _assert_state(got, want):
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **FIELDS_TOL)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **GLOBALS_TOL)
    assert got.iteration == int(want.iteration)


# --------------------------------------------------------------------------- #
# the stage plan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["d2q9_kuper", "d2q9"])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_action_plan_matches_reference(name, fuse):
    got = gk.action_plan(get_model(name), "Iteration", fuse=fuse)
    want = pallas_generic.action_plan(jax_model(name), "Iteration",
                                      fuse=fuse)
    assert got == want
    for stage in get_model(name).stages:
        assert gk.stage_reach(get_model(name), stage) == \
            pallas_generic._stage_reach(jax_model(name), stage)
    if name == NAME and fuse == 1:
        assert got == ([("BaseIteration", 1), ("CalcPhi", 0)], 2)


# --------------------------------------------------------------------------- #
# plain versions against the Pallas engines (interpret mode) and XLA
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("engine", ["band", "resident"])
def test_plain_engine_matches_pallas_and_xla(engine):
    """Five Iterations: the band engine is four plain launches and one
    globals launch; the resident engine one 4-step launch and one globals
    launch.  Fields and the last step's globals against the JAX package's
    generic engine of the same kind (in-kernel globals, full_globals) and
    against its XLA engine."""
    a, b = lattice_pair(1)
    if engine == "band":
        jit = pallas_generic.make_pallas_iterate(
            a.model, KUPER_SHAPE, jnp.float32, interpret=True)
        port = gk.make_band_iterate(b.model, KUPER_SHAPE)
    else:
        jit = pallas_generic.make_resident_iterate(
            a.model, KUPER_SHAPE, jnp.float32, interpret=True)
        port = gk.make_resident_iterate(b.model, KUPER_SHAPE)
    assert jit.full_globals and port.full_globals
    got = port(b.state, b.params, NITER)
    _assert_state(got, jit(_copy(a.state), a.params, NITER))
    _assert_state(got, jax_make_iterate(a.model)(_copy(a.state), a.params,
                                                 NITER))
    assert abs(float(got.globals_[1])) > 0     # WallForceY


def test_cpu_tensor_takes_plain_version_without_counting():
    _, b = lattice_pair(4)
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    gk.reset_launches()
    for name, (fn, n) in gk.WRAPPERS.items():
        assert torch.equal(fn(f, flags, ztab, args),
                           gk.plain_steps(f, flags, ztab, args, n)), name
    got, g = gk.step_globals(f, flags, ztab, args)
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    assert torch.equal(got, want) and torch.equal(g, wg)
    assert torch.equal(gk.resident(f, flags, ztab, args, 2),
                       gk.plain_steps(f, flags, ztab, args, 2))
    assert gk.LAUNCHES == {name: 0 for name in gk.KERNELS
                           + gk.BF16_KERNELS}
    assert set(gk.FLAVOUR_LAUNCHES.values()) == {0}
    assert gk.flavours() == {"plain": 0, "globals": 0}
    with pytest.raises(ValueError, match="even count"):
        gk.resident(f, flags, ztab, args, 3)


# --------------------------------------------------------------------------- #
# engine choice and the full_globals contract (no card needed)
# --------------------------------------------------------------------------- #


def test_engine_choice(monkeypatch):
    tm = get_model(NAME)
    # drop.xml's 128^2 fits half the L2; bench.py's 1024^2 (88.1 MB) not
    assert gk.supports_resident(tm, (128, 128), torch.float32)
    assert not gk.supports_resident(tm, (1024, 1024), torch.float32)
    assert gk.supports(tm, (1024, 1024), torch.float32)
    assert gk.supports(tm, (37, 53), torch.float32)   # no alignment needed
    assert not gk.supports(tm, (128, 128), torch.float64)
    # d2q9 has a device header (for its Control series); a model without
    # one is not taken
    assert gk.supports(get_model("d2q9"), (128, 128), torch.float32)
    assert not gk.supports(get_model("d2q9_SRT"), (128, 128),
                           torch.float32)
    assert not gk.supports(get_model("d3q27_cumulant"), (8, 8, 8),
                           torch.float32)
    assert gk.select_engine(tm, (128, 128), torch.float32)[1] \
        == "cuda_generic_resident[d2q9_kuper,fuse=N]"
    it, tag = gk.select_engine(tm, (1024, 1024), torch.float32)
    assert tag == "cuda_generic_band[d2q9_kuper,fuse=1]" and it.full_globals
    assert gk.select_engine(tm, (16, 16), torch.float64) == (None, None)
    # the Lattice takes the kernels on the card only
    monkeypatch.delenv("TCLB_FASTPATH", raising=False)
    auto = Lattice(tm, (16, 16), dtype=torch.float32, device="cpu")
    assert auto.engine_name == "eager"


def test_lattice_full_globals_runs_no_eager_step(monkeypatch):
    """Lattice.iterate with the generic engine set on CPU tensors: all
    seven steps on the engine (one 6-step resident launch, one globals
    launch), no eager step, the same state and globals as seven eager
    steps."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    _, b = lattice_pair(3)
    ref = Lattice(b.model, KUPER_SHAPE, dtype=torch.float32, device="cpu")
    ref.set_state(b.state, b.params)
    b._fast, b._fast_name = gk.select_engine(b.model, b.shape, b.dtype)
    b._fast_tried = True
    calls = []
    inner = gk.resident
    monkeypatch.setattr(gk, "resident", lambda *args: calls.append(
        args[-1]) or inner(*args))
    b.iterate(7)
    ref.iterate(7)
    assert b.engine_name == "cuda_generic_resident[d2q9_kuper,fuse=N]"
    assert calls == [6]
    assert b.eager_steps == 0 and ref.eager_steps == 7
    assert b.state.iteration == ref.state.iteration
    assert torch.equal(b.state.fields, ref.state.fields)
    assert b.get_globals() == ref.get_globals()


# --------------------------------------------------------------------------- #
# bounds
# --------------------------------------------------------------------------- #


def test_bound_counts():
    """Bytes and operations of one launch, as chip_smoke.py reports them."""
    tm = get_model(NAME)
    # 10 planes read and written, int32 flags, the Density zone table
    assert gk.launch_bytes(tm, (1024, 1024)) == \
        84 * 1024 * 1024 + 4 * tm.zone_max
    flags = rich_flags_kuper(tm, *KUPER_SHAPE).astype(np.int64)

    def count(name):
        t = tm.node_types[name]
        return int(((flags & t.mask) == t.value).sum())

    coll = int(((flags & tm.group_masks["COLLISION"]) != 0).sum())
    assert coll and count("Wall") and count("MovingWall")
    # by hand: a collision node 388 (rho 8, j 10, 2 divisions, equilibria
    # 2 x 53, f - feq 9, M rows 8 + 5 + 5 + 8 + 8 + 5 + 5 + 3 + 3, keep
    # factors 9, Minv rows 7 + 8 x 8, + feq2 9, forced velocity 6, force
    # 40 + 4 + 10 + 2), a Wall node 16, a MovingWall node 6, CalcPhi 31
    n = KUPER_SHAPE[0] * KUPER_SHAPE[1]
    assert gk.node_step_flops(tm, flags) == (
        388 * coll + 16 * count("Wall") + 6 * count("MovingWall") + 31 * n)


# --------------------------------------------------------------------------- #
# the device header and the build
# --------------------------------------------------------------------------- #


def _header() -> str:
    return (_cuda_build.CSRC / gk.DEVICE_MODELS[NAME].header).read_text()


def _enum(text: str, name: str) -> list[str]:
    body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
    return [t.strip() for t in body.split(",") if t.strip()][:-1]


def _table(text: str, fn: str) -> np.ndarray:
    body = re.search(r"constexpr \w+ %s\([^)]*\) \{\s*constexpr \w+ t"
                     r"[^=]*= \{(.*?)\};" % fn, text, re.S).group(1)
    items = re.sub(r"[{}\s]|(?<=[\d.])f", "", body).split(",")
    return np.array([eval(v) for v in items if v])  # noqa: S307


def test_device_header_matches_registry():
    """csrc/models/d2q9_kuper.cuh indexes the registry by position: its
    enums must list DEVICE_MODELS' names, which check_layout holds against
    the model, and its tables the model's lattice."""
    from tclb_tpu_torch.models import d2q9_kuper as kuper
    text = _header()
    dm = gk.DEVICE_MODELS[NAME]
    m = get_model(NAME)
    gk.check_layout(m)
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    np.testing.assert_array_equal(_table(text, "ex"), m.ei[:, 0])
    np.testing.assert_array_equal(_table(text, "ey"), m.ei[:, 1])
    np.testing.assert_allclose(_table(text, "wd"), kuper.W, rtol=1e-15)
    np.testing.assert_array_equal(_table(text, "opp"), kuper.OPP)
    np.testing.assert_array_equal(_table(text, "mirror_y"), kuper.MIRROR_Y)
    np.testing.assert_array_equal(_table(text, "gs"), kuper.GS)
    np.testing.assert_array_equal(_table(text, "basis").reshape(9, 9),
                                  kuper.M)
    np.testing.assert_array_equal(_table(text, "norm"),
                                  (kuper.M * kuper.M).sum(axis=1))
    np.testing.assert_allclose(lbm.inverse_basis(kuper.M),
                               (kuper.M / (kuper.M * kuper.M).sum(
                                   axis=1)[:, None]).T)
    for const in ("A2", "B2", "C2"):
        value = re.search(r"constexpr double %s = ([^;]+);" % const,
                          text).group(1)
        assert eval(value) == getattr(kuper, const), const  # noqa: S307
    with pytest.raises(ValueError, match="not the one"):
        gk.DEVICE_MODELS["d2q9_SRT"] = dm
        try:
            gk.check_layout(get_model("d2q9_SRT"))
        finally:
            del gk.DEVICE_MODELS["d2q9_SRT"]


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """generic2d.cu builds once per model, the model's header pre-included,
    each library with its own digest.  Editing a model's header changes
    that model's digest only, and those of the headers that include it
    (d2q9_kuper_adj's includes d2q9_kuper.cuh; a stale build is never
    reused); editing the
    adjoint header, the storage seams or the resident kernel's waits
    (resident_sync.cuh) generic2d.cu includes changes all of them; editing the shared d2q9 blocks changes the eighteen
    one-stage, multi-stage, adjoint and phase-field models built on them
    (not wave and wave2d), the phase-field blocks the two models built on
    those; editing a file none includes changes none."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC, csrc)
    monkeypatch.setattr(_cuda_build, "CSRC", csrc)
    assert [p.name for p in _cuda_build.included(csrc / "generic2d.cu")] \
        == ["generic2d.cu", "generic_common.cuh", "resident_sync.cuh",
            "storage.cuh", "generic2d_adjoint.cuh"]
    headers = {m: dm.header for m, dm in gk.DEVICE_MODELS.items()
               if dm.ndim == 2}
    onestage = {"d2q9_heat", "d2q9_heat_conjugate", "d2q9_hb", "sw",
                "d2q9_solid", "d2q9_npe_guo"}
    multistage = {"d2q9_pf_pressureEvolution", "d2q9_pp_MCMP", "d2q9_lee",
                  "d2q9_poison_boltzmann"}
    adjoint = {"d2q9_heat_adj", "d2q9_adj", "d2q9_optimalMixing",
               "d2q9_plate"}
    phase = {"d2q9_pf", "d2q9_pf_curvature"}
    common_too = {"d2q9_diff", "d2q9_pp_LBL"} | phase
    assert set(headers) == {"d2q9", "d2q9_kuper", "d2q9_kuper_adj", "wave",
                            "wave2d"} \
        | onestage | multistage | adjoint | common_too

    def digests():
        return {m: _cuda_build.digest("generic2d", h)
                for m, h in headers.items()}

    before = digests()
    assert len(set(before.values())) == 23
    d2q9 = _cuda_build.digest("d2q9")
    header = csrc / "models" / "d2q9_kuper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = digests()
    assert edited["d2q9_kuper"] != before["d2q9_kuper"]
    # d2q9_kuper_adj's header includes d2q9_kuper.cuh
    assert edited["d2q9_kuper_adj"] != before["d2q9_kuper_adj"]
    assert edited["d2q9_heat_adj"] == before["d2q9_heat_adj"]
    assert edited["d2q9"] == before["d2q9"]
    assert _cuda_build.digest("d2q9") == d2q9
    (csrc / "d3q27.cu").write_text("// edited\n")
    assert digests() == edited
    adj = csrc / "generic2d_adjoint.cuh"
    adj.write_text(adj.read_text() + "\n// edited\n")
    assert all(a != b for a, b in zip(digests().values(), edited.values()))
    again = digests()
    seams = csrc / "storage.cuh"
    seams.write_text(seams.read_text() + "\n// edited\n")
    assert all(a != b for a, b in zip(digests().values(), again.values()))
    again = digests()
    sync = csrc / "resident_sync.cuh"
    sync.write_text(sync.read_text() + "\n// edited\n")
    assert all(a != b for a, b in zip(digests().values(), again.values()))
    again = digests()
    common = csrc / "models" / "d2q9_common.cuh"
    common.write_text(common.read_text() + "\n// edited\n")
    assert {m for m, d in digests().items() if d != again[m]} == \
        onestage | multistage | adjoint | common_too
    again = digests()
    pf = csrc / "models" / "d2q9_pf_common.cuh"
    pf.write_text(pf.read_text() + "\n// edited\n")
    assert {m for m, d in digests().items() if d != again[m]} == phase


# --------------------------------------------------------------------------- #
# d2q9 on the generic kernels (csrc/models/d2q9.cuh)
# --------------------------------------------------------------------------- #

D2Q9_SHAPE = (16, 128)     # nx a multiple of 128: the reference's call_g


def d2q9_pair(seed):
    """The rich d2q9 state (every node type, zonal in/outlets, objective
    columns) in both packages, f32."""
    a = JaxLattice(jax_model("d2q9"), D2Q9_SHAPE, dtype=jnp.float32,
                   settings=RICH_SETTINGS)
    b = Lattice(get_model("d2q9"), D2Q9_SHAPE, dtype=torch.float32,
                settings=RICH_SETTINGS, device="cpu")
    return paint_rich(a, seed), paint_rich(b, seed)


@pytest.mark.parametrize("engine", ["band", "resident"])
def test_d2q9_plain_engine_matches_pallas_and_xla(engine):
    """d2q9's plain K4 (four plain launches and one globals launch) and
    K5 (one 4-step launch, then the globals launch) against the JAX
    package's generic engines of the same kind in interpret mode and its
    XLA engine."""
    a, b = d2q9_pair(2)
    present = jax_present(a.model, a._host_flags)
    if engine == "band":
        jit = pallas_generic.make_pallas_iterate(
            a.model, D2Q9_SHAPE, jnp.float32, interpret=True,
            present=present)
        port = gk.make_band_iterate(b.model, D2Q9_SHAPE)
    else:
        jit = pallas_generic.make_resident_iterate(
            a.model, D2Q9_SHAPE, jnp.float32, interpret=True,
            present=present)
        port = gk.make_resident_iterate(b.model, D2Q9_SHAPE)
    assert jit.full_globals and port.full_globals
    got = port(b.state, b.params, NITER)
    _assert_state(got, jit(_copy(a.state), a.params, NITER))
    _assert_state(got, jax_make_iterate(a.model)(_copy(a.state), a.params,
                                                 NITER))
    assert np.all(got.globals_.numpy() != 0)


def test_d2q9_bound_counts():
    """d2q9's operations: d2q9_kernels' step count and, at an Inlet or
    Outlet MRT node, the objectives (10); bytes: 11 planes read and
    written, the flags, two zone tables."""
    from tclb_tpu_torch.ops import d2q9_kernels as dk
    m = get_model("d2q9")
    flags = rich_flags(m, *D2Q9_SHAPE)
    objective = gk.count_types(m, flags, "Inlet", "Outlet")
    assert objective == 2 * (D2Q9_SHAPE[0] - 4)
    assert gk.node_step_flops(m, flags) == \
        dk.node_step_flops(m, flags) + 10 * objective
    assert gk.launch_bytes(m, (96, 512)) == 92 * 96 * 512 + 8 * m.zone_max


def test_d2q9_device_header_matches_registry():
    """csrc/models/d2q9.cuh's enums list DEVICE_MODELS' names (held to the
    registry by check_layout) and its tables the model's lattice."""
    from tclb_tpu_torch.models import d2q9
    text = (_cuda_build.CSRC / gk.DEVICE_MODELS["d2q9"].header).read_text()
    dm = gk.DEVICE_MODELS["d2q9"]
    m = get_model("d2q9")
    gk.check_layout(m)
    assert _enum(text, "Setting") == ["S_" + s for s in dm.settings]
    assert _enum(text, "NodeType") == ["T_" + s for s in dm.node_types]
    assert _enum(text, "Group") == ["G_" + s for s in dm.groups]
    assert _enum(text, "Zonal") == ["Z_" + s for s in dm.zonal]
    assert _enum(text, "Global") == ["GL_" + s for s in dm.globals_]
    np.testing.assert_array_equal(_table(text, "ex"), m.ei[:, 0])
    np.testing.assert_array_equal(_table(text, "ey"), m.ei[:, 1])
    np.testing.assert_allclose(_table(text, "wd"), d2q9.W, rtol=1e-15)
    np.testing.assert_array_equal(_table(text, "opp"), d2q9.OPP)
    np.testing.assert_array_equal(_table(text, "basis").reshape(9, 9),
                                  d2q9.M)
    np.testing.assert_array_equal(_table(text, "norm"),
                                  (d2q9.M * d2q9.M).sum(axis=1))
    # no stage reads a time derivative: the kernels compute none
    assert "setting_dt" not in text


# --------------------------------------------------------------------------- #
# the storage ladder: the plain versions of the bf16 flavours
# --------------------------------------------------------------------------- #

from tclb_tpu.core import shift as jax_shift  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy  # noqa: E402
from tclb_tpu_torch.core import shift as ddf  # noqa: E402
from tclb_tpu_torch.core.lattice import make_iterate  # noqa: E402
from torch_cases import HEAT_SETTINGS, paint_rich_heat  # noqa: E402

# model -> (settings, painter, shape) of the rich bf16 states
BF16_CASES = {"d2q9": (RICH_SETTINGS, paint_rich, (16, 64)),
              "d2q9_kuper": (KUPER_SETTINGS, paint_rich_kuper, KUPER_SHAPE),
              "d2q9_heat_adj": (HEAT_SETTINGS, paint_rich_heat, (32, 64))}


def bf16_lattice(cls, name, storage_repr, seed=5):
    settings, paint, shape = BF16_CASES[name]
    if cls is Lattice:
        lat = Lattice(get_model(name), shape, dtype=torch.float32,
                      settings=settings, device="cpu",
                      storage_dtype=torch.bfloat16,
                      storage_repr=storage_repr)
    else:
        lat = JaxLattice(jax_model(name), shape, dtype=jnp.float32,
                         settings=settings, storage_dtype=jnp.bfloat16,
                         storage_repr=storage_repr)
    return paint(lat, seed)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return ddf.bf16_bits(a)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plain_kernels_equal_narrowed_eager(name, storage_repr):
    """Each bf16 wrapper on CPU tensors is the narrowed eager engine at
    its kernel's cadence (widen, one Iteration in f32, narrow, per step),
    bit for bit: step, step_globals (and its globals) and an 8-step
    resident, with no launch counted."""
    b = bf16_lattice(Lattice, name, storage_repr)
    m = b.model
    shift = ddf.kernel_shift(m, storage_repr)
    f, flags, ztab, args = gk.kernel_inputs(m, b.state, b.params, shift)
    assert f.dtype == torch.bfloat16 and args.shift == shift
    eager = make_iterate(m, storage_dtype=torch.bfloat16,
                         storage_shift=ddf.stack_shift(m, storage_repr))
    gk.reset_launches()
    one = eager(b.state, b.params, 1)
    got, g = gk.step_globals(f, flags, ztab, args)
    assert torch.equal(_bits_t(gk.step(f, flags, ztab, args)),
                       _bits_t(one.fields))
    assert torch.equal(_bits_t(got), _bits_t(one.fields))
    assert torch.equal(g, one.globals_)
    eight = eager(b.state, b.params, 8)
    assert torch.equal(_bits_t(gk.resident(f, flags, ztab, args, 8)),
                       _bits_t(eight.fields))
    assert set(gk.LAUNCHES.values()) == {0}
    assert set(gk.FLAVOUR_LAUNCHES.values()) == {0}


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plain_band_matches_pallas(name, storage_repr):
    """The plain bf16 K4 (the band engine on CPU tensors, fuse=1) against
    the JAX package's ``pallas_generic.make_pallas_iterate`` at bf16 in
    interpret mode, from the same bf16 state: one Iteration bit for bit
    for d2q9, d2q9_kuper and d2q9_heat_adj raw (d2q9 also after three);
    d2q9_heat_adj shifted within the f32 tolerance carried through the
    narrowing (its f32 engines sit an ulp apart at some nodes, and a
    shifted bf16 deviation resolves that ulp at a few of them)."""
    a = bf16_lattice(JaxLattice, name, storage_repr)
    m = get_model(name)
    shape = BF16_CASES[name][2]
    state, params = state_from_numpy(
        m, np.asarray(a.state.fields), np.asarray(a.state.flags),
        np.asarray(a.state.globals_), a.state.iteration,
        np.asarray(a.params.settings), np.asarray(a.params.zone_table),
        device="cpu")
    it = pallas_generic.make_pallas_iterate(
        a.model, shape, jnp.bfloat16, interpret=True, fuse=1,
        present=jax_present(a.model, np.asarray(a.state.flags)),
        shift=jax_shift.shift_of(a.model, storage_repr))
    port = gk.make_band_iterate(m, shape, torch.bfloat16, storage_repr)
    for niter in ((1, 3) if name == "d2q9" else (1,)):
        want = it(_copy(a.state), a.params, niter)
        got = port(state, params, niter)
        assert got.fields.dtype == torch.bfloat16
        if name == "d2q9_heat_adj" and storage_repr == "shifted":
            sb = ddf.stack_shift(m, storage_repr)
            wide = make_iterate(m)(dataclasses.replace(
                state, fields=ddf.widen_stack(state.fields, torch.float32,
                                              sb)), params, 1).fields
            lo, hi = ddf.narrowed_bounds(wide, torch.bfloat16, sb,
                                         **FIELDS_TOL)
            w = torch.from_numpy(np.asarray(want.fields, np.float64))
            assert bool(((w >= lo.double()) & (w <= hi.double())).all())
            assert int((_bits(got.fields) != _bits(want.fields)).sum()) <= 4
        else:
            np.testing.assert_array_equal(_bits(got.fields),
                                          _bits(want.fields))


def test_bf16_bounds_and_selection():
    """A bf16 node moves 2 B a plane each way: d2q9 48 B (11 planes and
    the flags), d2q9_kuper 44 B; the resident engine counts its L2 at that
    size, so a lattice too large for it in f32 fits in bf16."""
    d2q9, kuper = get_model("d2q9"), get_model("d2q9_kuper")
    n = 1024 * 1024
    assert gk.launch_bytes(d2q9, (1024, 1024), itemsize=2) == \
        48 * n + 8 * d2q9.zone_max
    assert gk.launch_bytes(kuper, (1024, 1024), itemsize=2) == \
        44 * n + 4 * kuper.zone_max
    shape = (512, 640)      # 27.5 MB of f32 stacks, 14.4 MB of bf16
    assert not gk.supports_resident(kuper, shape, torch.float32)
    assert gk.supports_resident(kuper, shape, torch.float32,
                                storage_dtype=torch.bfloat16)
    assert not gk.supports(kuper, shape, torch.float32,
                           storage_dtype=torch.float16)
    it = gk.make_band_iterate(kuper, shape, torch.bfloat16, "shifted")
    assert it.full_globals and not it.supports_series
