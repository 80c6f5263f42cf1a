"""<Control> time series in the port against the JAX package.

The series state (``series_overrides``, ``series_dt_overrides``,
``NodeCtx.setting_dt``), the eager engine under a series at f64 (d2q9,
d2q9_kuper, d3q19_adj), the plain versions of the series kernel flavours
(``generic2d_step_series``: the JAX package's ``call_s`` and ``call_sg`` in
interpret mode; ``generic3d_step_series``: its XLA engine), the engine
choice under a series, ``<Control>`` through both control planes, and a
checkpoint with a series across the two packages.  The CUDA flavours are
held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import xml.etree.ElementTree as ET  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.core import lattice as jax_lattice  # noqa: E402
from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from tclb_tpu_torch.core import lattice  # noqa: E402
from tclb_tpu_torch.ops import d2q9_kernels as dk  # noqa: E402
from tclb_tpu_torch.ops import d3q27_kernels as dk3  # noqa: E402
from tclb_tpu_torch.ops import generic3d_kernels as g3  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (ADJ3D_SETTINGS, ADJ3D_SHAPE,  # noqa: E402
                         KUPER_SETTINGS, KUPER_SHAPE, RICH_SERIES_T,
                         RICH_SETTINGS, SERIES_SETTINGS, add_rich_series,
                         adj3d_control_xml, paint_rich, paint_rich_adj3d,
                         paint_rich_kuper, ramp_csv, series_flags,
                         series_values)

RTOL, ATOL = 1e-10, 1e-12      # tests/test_golden.py's csvdiff model
F64_TOL = dict(rtol=RTOL, atol=ATOL)
# f32 engines against each other: tests/test_pallas_generic.py's series
# tests (fields) and tests/test_fastpath.py (globals)
SERIES_FIELDS_TOL = dict(rtol=1e-5, atol=1e-6)
F32_TOL = dict(rtol=2e-5, atol=2e-6)
GLOBALS_TOL = dict(rtol=1e-4, atol=1e-6)
D2Q9_SHAPE = (24, 48)

RICH = {"d2q9": (D2Q9_SHAPE, RICH_SETTINGS, paint_rich),
        "d2q9_kuper": (KUPER_SHAPE, KUPER_SETTINGS, paint_rich_kuper),
        "d3q19_adj": (ADJ3D_SHAPE, ADJ3D_SETTINGS, paint_rich_adj3d)}


def rich_pair(name, prec="f64", seed=3):
    """The same rich state with series on two zones in both packages."""
    shape, settings, paint = RICH[name]
    jd, td = ((jnp.float64, torch.float64) if prec == "f64"
              else (jnp.float32, torch.float32))
    a = JaxLattice(jax_model(name), shape, dtype=jd, settings=settings)
    b = Lattice(get_model(name), shape, dtype=td, settings=settings,
                device="cpu")
    return (add_rich_series(paint(a, seed)),
            add_rich_series(paint(b, seed)))


def _copy(state):
    # the JAX engines donate their input state
    return jax.tree.map(jnp.copy, state)


# --------------------------------------------------------------------------- #
# the series state
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fn", ["series_overrides", "series_dt_overrides"])
@pytest.mark.parametrize("name", sorted(RICH))
def test_series_overrides_match_reference(name, fn):
    """Each zonal setting's overrides at iterations inside the horizon,
    at its two ends and past it (the mod-T wrap)."""
    a, b = rich_pair(name)
    assert b.params.series_map == a.params.series_map
    np.testing.assert_array_equal(b.params.time_series.numpy(),
                                  np.asarray(a.params.time_series))
    T = RICH_SERIES_T
    for i in range(len(b.model.settings)):
        for it in (0, 1, T - 1, T, 3 * T + 2):
            got = getattr(lattice, fn)(b.params, i, it)
            want = getattr(jax_lattice, fn)(a.params, i, it)
            assert [z for z, _ in got] == [z for z, _ in want]
            np.testing.assert_allclose([float(v) for _, v in got],
                                       [float(v) for _, v in want],
                                       **F64_TOL)


def test_setting_and_setting_dt_match_reference():
    """NodeCtx.setting and NodeCtx.setting_dt planes of every zonal
    setting on the rich d2q9 state, at iterations that wrap."""
    a, b = rich_pair("d2q9")
    for it in (0, 2, RICH_SERIES_T, 2 * RICH_SERIES_T + 4):
        ca = jax_lattice.NodeCtx(a.model, a.state.fields, a.state.fields,
                                 a.state.flags, a.params, iteration=it)
        cb = lattice.NodeCtx(b.model, b.state.fields, b.state.fields,
                             b.state.flags, b.params, iteration=it)
        for s in b.model.zonal_settings:
            np.testing.assert_allclose(cb.setting(s).numpy(),
                                       np.asarray(ca.setting(s)), **F64_TOL)
            np.testing.assert_allclose(cb.setting_dt(s).numpy(),
                                       np.asarray(ca.setting_dt(s)),
                                       **F64_TOL)
    assert np.abs(cb.setting_dt("Velocity").numpy()).max() > 0


@pytest.mark.parametrize("name", sorted(RICH))
def test_eager_series_matches_reference(name):
    """20 eager steps under series on two zones with a horizon of 5 (the
    iteration wraps four times) against the JAX package's XLA engine at
    f64: fields, the last step's globals and the iteration."""
    a, b = rich_pair(name)
    start = b.state.iteration      # d2q9_kuper's Init streams once
    assert start == int(a.state.iteration)
    want = jax_lattice.make_iterate(a.model)(a.state, a.params, 20)
    b.iterate(20)
    assert b.engine_name == "eager" and b.eager_steps == 20
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(want.fields), **F64_TOL)
    np.testing.assert_allclose(b.state.globals_.numpy(),
                               np.asarray(want.globals_), **F64_TOL)
    assert b.state.iteration == int(want.iteration) == start + 20


def test_series_changes_the_flow():
    """The same 20 steps without the series differ: the overrides are
    read, not ignored."""
    _, b = rich_pair("d2q9")
    shape, settings, paint = RICH["d2q9"]
    c = paint(Lattice(b.model, shape, dtype=torch.float64,
                      settings=settings, device="cpu"), 3)
    b.iterate(20)
    c.iterate(20)
    assert not torch.allclose(b.state.fields, c.state.fields, rtol=1e-6)


def test_set_setting_series_contract():
    """One horizon for every series, zonal settings only, the engine
    chosen again, and set_setting keeps the series."""
    _, b = rich_pair("d2q9")
    b._fast_tried = True
    b.set_setting_series("Velocity", series_values(RICH_SERIES_T), zone=0)
    assert not b._fast_tried
    assert b.params.series_map == ((2, 0, 0), (2, 1, 1), (3, 2, 2))
    with pytest.raises(ValueError, match="one horizon"):
        b.set_setting_series("Velocity", np.zeros(7), zone=3)
    with pytest.raises(ValueError, match="not zonal"):
        b.set_setting_series("nu", np.zeros(RICH_SERIES_T))
    b.set_setting("nu", 0.07)
    assert b.params.series_map == ((2, 0, 0), (2, 1, 1), (3, 2, 2))
    assert tuple(b.params.time_series.shape) == (3, RICH_SERIES_T)


# --------------------------------------------------------------------------- #
# engine choice under a series
# --------------------------------------------------------------------------- #


def _chosen(name, shape, series):
    """The engine tag ``Lattice._build_fast`` picks for an f32 lattice as
    on the card (selection only: nothing is built or launched)."""
    m = get_model(name)
    lat = Lattice(m, shape, dtype=torch.float32, device="cpu")
    if series:
        z = 0
        lat.set_setting_series(m.zonal_settings[0], np.full(4, 0.01), z)
    lat.device = torch.device("cuda")
    fast, tag = lat._build_fast()
    if fast is not None and series:
        assert fast.supports_series and fast.full_globals
    return tag


@pytest.mark.parametrize("name,shape,plain,series", [
    ("d2q9", (96, 512), "cuda_d2q9_resident[d2q9,fuse=8]",
     "cuda_generic_band[d2q9,fuse=1]"),
    ("d2q9", (1024, 1024), "cuda_d2q9_band[d2q9,fuse=2]",
     "cuda_generic_band[d2q9,fuse=1]"),
    ("d2q9_kuper", (128, 128), "cuda_generic_resident[d2q9_kuper,fuse=N]",
     "cuda_generic_band[d2q9_kuper,fuse=1]"),
    ("d3q19_adj", (8, 16, 32), "cuda_generic3d_band[d3q19_adj,fuse=1]",
     "cuda_generic3d_band[d3q19_adj,fuse=1]"),
    ("d3q27_cumulant", (8, 8, 32), "cuda_d3q27_band[d3q27_cumulant,fuse=2]",
     None),
    ("d2q9_SRT", (96, 512), "cuda_d2q9_resident[d2q9_SRT,fuse=8]", None),
])
def test_engine_choice_under_series(name, shape, plain, series):
    """Without a series nothing changes (d2q9 keeps K1/K2); under one the
    tuned kernels and the resident engines reject it, the generic band
    engines take it, and a model with no device header runs eager."""
    assert _chosen(name, shape, False) == plain
    assert _chosen(name, shape, True) == series


def test_kernel_modules_reject_or_take_a_series():
    d2q9, kuper = get_model("d2q9"), get_model("d2q9_kuper")
    assert dk.select_engine(d2q9, (96, 512), torch.float32,
                            series=True) == (None, None)
    assert dk3.select_engine(get_model("d3q27_cumulant"), (8, 8, 32),
                             torch.float32, series=True) == (None, None)
    assert gk.supports_resident(kuper, (128, 128), torch.float32)
    assert not gk.supports_resident(kuper, (128, 128), torch.float32,
                                    series=True)
    it, tag = g3.select_engine(get_model("d3q19_adj"), (8, 16, 32),
                               torch.float32, series=True)
    assert it.supports_series and tag.startswith("cuda_generic3d_band")


def test_lattice_runs_series_band_engine_without_eager_steps(monkeypatch):
    """Lattice.iterate with the band engine set on CPU tensors under a
    series: seven steps on the engine's series flavours (plain versions,
    nothing counted), no eager step, the state of seven eager steps."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    _, b = rich_pair("d2q9", "f32")
    ref = Lattice(b.model, b.shape, dtype=torch.float32, device="cpu")
    ref.set_state(b.state, b.params)
    assert ref.params.series_map == b.params.series_map
    b._fast, b._fast_name = gk.select_engine(b.model, b.shape, b.dtype,
                                             series=True)
    b._fast_tried = True
    gk.reset_launches()
    b.iterate(7)
    ref.iterate(7)
    assert b.engine_name == "cuda_generic_band[d2q9,fuse=1]"
    assert b.eager_steps == 0 and ref.eager_steps == 7
    assert set(gk.SERIES_LAUNCHES.values()) == {0}
    assert b.state.iteration == ref.state.iteration == 7
    np.testing.assert_allclose(b.state.fields.numpy(),
                               ref.state.fields.numpy(), **F32_TOL)
    np.testing.assert_allclose(b.state.globals_.numpy(),
                               ref.state.globals_.numpy(), **GLOBALS_TOL)


def test_engine_without_series_support_is_refused():
    """An engine picked before a series and kept (not chosen again)
    raises rather than ignoring the series."""
    _, b = rich_pair("d2q9", "f32")
    b._fast, b._fast_name = dk.select_engine(b.model, b.shape, b.dtype)
    b._fast_tried = True
    with pytest.raises(RuntimeError, match="cannot read a Control"):
        b.iterate(2)


# --------------------------------------------------------------------------- #
# the plain series flavours against the reference's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape,T,niter,objectives", [
    ((16, 64), 11, 7, False),      # call_s (test_pallas_generic.py:222)
    ((16, 128), 9, 6, True),       # call_sg (test_pallas_generic.py:252)
])
def test_plain_series_flavours_match_pallas(shape, T, niter, objectives,
                                            monkeypatch):
    """The band engine's series flavours (plain versions on the CPU)
    against the JAX package's Lattice under TCLB_FASTPATH=force (its
    generic engine in interpret mode, series flavours) and against its
    XLA engine: the reference's own cases and tolerances (fields rtol
    1e-5 / atol 1e-6, globals rtol 1e-4 / atol 1e-6)."""
    series = series_values(T, rate=0.7 if T == 11 else 0.9,
                           amp=0.005 if T == 11 else 0.004)
    lats = []
    for lat in (JaxLattice(jax_model("d2q9"), shape, dtype=jnp.float32,
                           settings=SERIES_SETTINGS),
                Lattice(get_model("d2q9"), shape, dtype=torch.float32,
                        settings=SERIES_SETTINGS, device="cpu")):
        lat.set_flags(series_flags(lat.model, *shape, objectives))
        lat.init()
        lat.set_setting_series("Velocity", series, zone=0)
        lats.append(lat)
    a, b = lats
    xla = jax_lattice.make_iterate(a.model)(_copy(a.state), a.params, niter)
    monkeypatch.setenv("TCLB_FASTPATH", "force")
    a.iterate(niter)
    assert "pallas_generic" in a._fast_name and a._fast.supports_series
    want = a.state
    gk.reset_launches()
    got = gk.make_band_iterate(b.model, shape)(b.state, b.params, niter)
    assert set(gk.SERIES_LAUNCHES.values()) == {0}
    for ref in (want, xla):
        np.testing.assert_allclose(got.fields.numpy(),
                                   np.asarray(ref.fields),
                                   **SERIES_FIELDS_TOL)
        assert got.iteration == int(ref.iteration) == niter
    if objectives:
        assert a._fast.full_globals
        np.testing.assert_allclose(got.globals_.numpy(),
                                   np.asarray(want.globals_), **GLOBALS_TOL)
        assert np.abs(np.asarray(want.globals_)).sum() > 0


def test_plain_series_step_reads_the_wrapped_entry():
    """One series step at iteration ``it`` equals one plain step on a
    zone table holding the series' entry ``it mod T``: what the CUDA
    flavour computes from its launch arguments."""
    _, b = rich_pair("d2q9", "f32")
    f, flags, ztab, a = gk.kernel_inputs(b.model, b.state, b.params)
    series = gk.series_inputs(b.model, b.params)
    assert series.row.dtype == torch.int32 and series.horizon == 5
    assert gk.series_map_of(series, b.model) == b.params.series_map
    it = 3 * RICH_SERIES_T + 2
    table = ztab.clone()
    row = series.row.numpy()
    for j, z in zip(*np.nonzero(row >= 0)):
        table[j, z] = series.ts[row[j, z], it % RICH_SERIES_T]
    got, g = gk.step_series_globals(f, flags, ztab, a, series, it)
    want, wg = gk.step_globals(f, flags, table, a)
    assert torch.equal(got, want) and torch.equal(g, wg)
    assert torch.equal(gk.step_series(f, flags, ztab, a, series, it),
                       gk.step(f, flags, table, a))


def test_plain_3d_series_flavours_match_reference():
    """The 3D band engine's series flavours (plain versions) on the rich
    d3q19_adj state with series on two zones, 12 steps (the horizon of 5
    wraps), against the JAX package's XLA engine at f32."""
    a, b = rich_pair("d3q19_adj", "f32", seed=4)
    g3.reset_launches()
    got = g3.make_band_iterate(b.model, ADJ3D_SHAPE)(b.state, b.params, 12)
    assert set(g3.SERIES_LAUNCHES.values()) == {0}
    want = jax_lattice.make_iterate(a.model)(_copy(a.state), a.params, 12)
    np.testing.assert_allclose(got.fields.numpy(), np.asarray(want.fields),
                               **F32_TOL)
    np.testing.assert_allclose(got.globals_.numpy(),
                               np.asarray(want.globals_), **GLOBALS_TOL)
    assert got.iteration == 12


def test_series_bytes():
    m = get_model("d2q9")
    plain = gk.launch_bytes(m, (96, 512))
    assert plain == (2 * 11 + 1) * 4 * 96 * 512 + 2 * 128 * 4
    # the row map (the zone table's size) and one entry of each series
    assert gk.launch_bytes(m, (96, 512), n_series=1) == plain + 2 * 128 * 4 + 4


# --------------------------------------------------------------------------- #
# <Control> through both control planes, checkpoints
# --------------------------------------------------------------------------- #


def test_control_3d_case_through_both_control_planes(tmp_path, monkeypatch):
    """The 3D Control channel (tests/torch_cases.py:adj3d_control_xml at
    8x16x32, 40 iterations under a CSV ramp) through both packages'
    _run_root at f64: the series, the fields and every Log column."""
    monkeypatch.chdir(tmp_path)
    ramp_csv(tmp_path / "ramp.csv")
    runs = {}
    for tag, run_root, get, dtype in (
            ("port", solver._run_root, get_model, torch.float64),
            ("ref", jax_solver._run_root, jax_model, jnp.float64)):
        out = tmp_path / tag
        root = ET.fromstring(adj3d_control_xml("ramp.csv",
                                               out=str(out) + "/"))
        kw = {"device": "cpu"} if tag == "port" else {}
        runs[tag] = run_root(root, get("d3q19_adj"), None, dtype,
                             str(out) + "/", "case", **kw)
    port, ref = runs["port"], runs["ref"]
    assert port.lattice.params.series_map == ref.lattice.params.series_map
    np.testing.assert_allclose(port.lattice.params.time_series.numpy(),
                               np.asarray(ref.lattice.params.time_series),
                               **F64_TOL)
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               **F64_TOL)
    lp = np.loadtxt(tmp_path / "port" / "case_Log.csv", delimiter=",",
                    skiprows=1)
    lr = np.loadtxt(tmp_path / "ref" / "case_Log.csv", delimiter=",",
                    skiprows=1)
    head = (tmp_path / "port" / "case_Log.csv").read_text().split("\n")[0]
    assert head == (tmp_path / "ref" / "case_Log.csv").read_text() \
        .split("\n")[0]
    keep = [i for i, h in enumerate(head.split(",")) if "Walltime" not in h]
    assert lp.shape == lr.shape == (4, len(head.split(",")))
    np.testing.assert_allclose(lp[:, keep], lr[:, keep], **F64_TOL)


@pytest.mark.parametrize("expr,want", [
    ("vel", lambda v: v),
    ("vel*2+0.001", lambda v: 2 * v + 0.001),
    ("-vel+1e-2", lambda v: 1e-2 - v),
    ("vel * -0.5", lambda v: -0.5 * v),
])
def test_control_expressions_match_reference(expr, want, tmp_path,
                                             monkeypatch):
    """<Params> expressions of CSV columns and constants, a CSV with a
    Time column, and the unknown-zone warning: the same series as the JAX
    package's."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.csv").write_text("t,vel\n0,0.01\n20,0.03\n50,0.02\n")
    xml = f"""<CLBConfig output="{{out}}/">
    <Geometry nx="32" ny="8"><MRT><Box/></MRT>
      <WVelocity name="inl"><Inlet/></WVelocity>
      <Wall mask="ALL"><Channel/></Wall></Geometry>
    <Model><Params nu="0.1"/></Model>
    <Control Iterations="60">
        <CSV file="c.csv" Time="t"/>
        <Params Velocity-inl="{expr}" Velocity-nowhere="vel"/>
    </Control>
    <Solve Iterations="5"/>
    </CLBConfig>"""
    ts = []
    for run, model, dtype, kw in (
            (solver.run_config_string, get_model("d2q9"), torch.float64,
             {"device": "cpu"}),
            (jax_solver.run_config_string, jax_model("d2q9"), jnp.float64,
             {})):
        out = tmp_path / str(len(ts))
        s = run(xml.format(out=out), model, dtype=dtype, **kw)
        ts.append(np.asarray(s.lattice.params.time_series))
        assert s.lattice.params.series_map == ((2, 1, 0),)
    np.testing.assert_allclose(ts[0], ts[1], **F64_TOL)
    vel = np.interp(np.arange(60), [0, 20, 50], [0.01, 0.03, 0.02])
    np.testing.assert_allclose(ts[0][0], want(vel), **F64_TOL)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_with_series_restores_across_packages(writer, tmp_path):
    """A .npz with a time series written by either package's save and
    read by the other's load: fields, iteration, the series and its map
    bit-exact at f64; the next 6 steps under the series agree."""
    a, b = rich_pair("d2q9")
    b.iterate(3)
    a.iterate(3)
    path = str(tmp_path / "ck.npz")
    if writer == "port":
        b.save(path)
        other = JaxLattice(a.model, D2Q9_SHAPE, dtype=jnp.float64)
        other.load(path)
        got_ts = np.asarray(other.params.time_series)
        got_fields = np.asarray(other.state.fields)
        want_ts, want_fields = b.params.time_series.numpy(), \
            b.state.fields.numpy()
        assert other.params.series_map == b.params.series_map
        assert int(other.state.iteration) == b.state.iteration == 3
        other.iterate(6)
        b.iterate(6)
        after = (np.asarray(other.state.fields), b.state.fields.numpy())
    else:
        a.save(path)
        other = Lattice(b.model, D2Q9_SHAPE, dtype=torch.float64,
                        device="cpu")
        other.load(path)
        got_ts = other.params.time_series.numpy()
        got_fields = other.state.fields.numpy()
        want_ts, want_fields = np.asarray(a.params.time_series), \
            np.asarray(a.state.fields)
        assert other.params.series_map == a.params.series_map
        assert other.state.iteration == int(a.state.iteration) == 3
        other.iterate(6)
        a.iterate(6)
        after = (other.state.fields.numpy(), np.asarray(a.state.fields))
    np.testing.assert_array_equal(got_ts, want_ts)
    np.testing.assert_array_equal(got_fields, want_fields)
    np.testing.assert_allclose(*after, **F64_TOL)


def test_state_with_series_converts_both_ways():
    a, b = rich_pair("d2q9")
    st, pa = state_from_numpy(
        b.model, np.asarray(a.state.fields), np.asarray(a.state.flags),
        np.asarray(a.state.globals_), a.state.iteration,
        np.asarray(a.params.settings), np.asarray(a.params.zone_table),
        device="cpu", time_series=np.asarray(a.params.time_series),
        series_map=a.params.series_map)
    assert pa.series_map == a.params.series_map
    assert torch.equal(pa.time_series, b.params.time_series)
    back = state_to_numpy(st, pa)
    np.testing.assert_array_equal(back["time_series"],
                                  np.asarray(a.params.time_series))
    assert back["series_map"] == a.params.series_map
