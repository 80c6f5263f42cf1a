"""The d2q9 (with the d2q9 family's branches), d3q27 (with the z-slab
family's branches), generic (2D and 3D, with their <Control> series
flavours) and adjoint CUDA kernels against their plain PyTorch versions on
the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, so on such a machine run it
without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from tclb_tpu_torch import Lattice, get_model
from tclb_tpu_torch.ops import d2q9_kernels as dk
from tclb_tpu_torch.ops import d3q27_kernels as dk3
from tclb_tpu_torch.ops import adjoint_kernels as ak
from tclb_tpu_torch.ops import generic3d_kernels as g3
from tclb_tpu_torch.ops import generic_kernels as gk
from torch_cases import (ADJ3D_SETTINGS, D3Q_FAMILY, FAMILY_MODELS,
                         HEAT_SETTINGS, KUPER_SETTINGS, RICH3D_SETTINGS,
                         RICH_SERIES_T, RICH_SETTINGS, add_rich_series,
                         bench_adjoint3d_lattice,
                         channel3d_flags, d3q_family_settings,
                         family_settings, heat_adj_golden_columns,
                         paint_rich, paint_rich_3d, paint_rich_adj3d,
                         paint_rich_d3q, paint_rich_family, paint_rich_heat,
                         paint_rich_kuper)

# the kernels contract multiply-adds and the plain version does not:
# tests/test_fastpath.py's f32 tolerance
FIELDS_TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture
def card_lattice():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(shape, seed):
        lat = Lattice(get_model("d2q9"), shape, dtype=torch.float32,
                      settings=RICH_SETTINGS, device="cuda")
        return paint_rich(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 1024), (37, 53), (256, 256)])
@pytest.mark.parametrize("name", dk.KERNELS)
def test_kernel_matches_plain(card_lattice, name, shape):
    lat = card_lattice(shape, seed=5)
    f, flags, vel, den, args = dk.kernel_inputs(lat.model, lat.state,
                                                lat.params)
    fn, n = dk.WRAPPERS[name]
    dk.reset_launches()
    got = fn(f, flags, vel, den, args)
    torch.cuda.synchronize()
    assert dk.LAUNCHES[name] == 1
    want = dk.plain_steps(f, flags, vel, den, args, n)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    assert torch.equal(got[9:], f[9:])     # BC planes carried through


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card_lattice):
    lat = card_lattice((16, 16), seed=1)
    f, flags, vel, den, args = dk.kernel_inputs(lat.model, lat.state,
                                                lat.params)
    with pytest.raises(ValueError, match="needs contiguous"):
        dk.step(f, flags.to(torch.int64), vel, den, args)
    with pytest.raises(ValueError, match="needs contiguous"):
        dk.step2(f, flags, vel.t(), den, args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,engine,kernels", [
    ((100, 1024), "cuda_d2q9_resident[d2q9,fuse=8]",
     ("d2q9_resident8", "d2q9_step")),
    ((1024, 1024), "cuda_d2q9_band[d2q9,fuse=2]",
     ("d2q9_step2", "d2q9_step")),
])
def test_lattice_engine_matches_eager(card_lattice, shape, engine, kernels):
    lat = card_lattice(shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    dk.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == engine
    for k in kernels:
        assert dk.LAUNCHES[k] >= 1, k
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    got, want = lat.get_globals(), ref.get_globals()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


@pytest.fixture
def card_lattice_family():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed):
        m = get_model(name)
        lat = Lattice(m, shape, dtype=torch.float32,
                      settings=family_settings(m), device="cuda")
        return paint_rich_family(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64), (37, 53), (128, 1024)])
@pytest.mark.parametrize("name", dk.KERNELS)
@pytest.mark.parametrize("model", FAMILY_MODELS)
def test_family_kernel_matches_plain(card_lattice_family, model, name,
                                     shape):
    """Each family model's branch of each kernel on a state that paints
    every node type the model reads."""
    lat = card_lattice_family(model, shape, seed=5)
    f, flags, vel, den, args = dk.kernel_inputs(lat.model, lat.state,
                                                lat.params)
    fn, n = dk.WRAPPERS[name]
    dk.reset_launches()
    got = fn(f, flags, vel, den, args)
    torch.cuda.synchronize()
    assert dk.LAUNCHES[dk.launch_key(name, model)] == 1
    assert sum(dk.LAUNCHES.values()) == 1
    torch.testing.assert_close(got, dk.plain_steps(f, flags, vel, den,
                                                   args, n), **FIELDS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("model", FAMILY_MODELS)
@pytest.mark.parametrize("shape,engine,kernels", [
    ((128, 1024), "resident", ("d2q9_resident8", "d2q9_step")),
    ((1024, 1024), "band", ("d2q9_step2", "d2q9_step")),
])
def test_family_lattice_engine_matches_eager(card_lattice_family, model,
                                             shape, engine, kernels):
    lat = card_lattice_family(model, shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    dk.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name.startswith(f"cuda_d2q9_{engine}[{model},")
    for k in kernels:
        assert dk.LAUNCHES[dk.launch_key(k, model)] >= 1, k
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    got, want = lat.get_globals(), ref.get_globals()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


@pytest.fixture
def card_lattice_3d():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(shape, seed):
        lat = Lattice(get_model("d3q27_cumulant"), shape,
                      dtype=torch.float32, settings=RICH3D_SETTINGS,
                      device="cuda")
        return paint_rich_3d(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 8, 64), (7, 9, 40), (48, 48, 256)])
@pytest.mark.parametrize("name", dk3.KERNELS)
def test_d3q27_kernel_matches_plain(card_lattice_3d, name, shape):
    """Every node type, the ragged edge of the 32x8 columns (7x9x40) and
    3d_channel's shape."""
    lat = card_lattice_3d(shape, seed=5)
    f, flags, ztab, args = dk3.kernel_inputs(lat.model, lat.state,
                                             lat.params)
    fn, n = dk3.WRAPPERS[name]
    dk3.reset_launches()
    got = fn(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert dk3.LAUNCHES[name] == 1
    want = dk3.plain_steps(f, flags, ztab, args, n)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    assert torch.equal(got[27:30], f[27:30])     # SynthT carried through


@pytest.mark.cuda
def test_d3q27_wrapper_rejects_what_the_kernel_does_not_take(
        card_lattice_3d):
    lat = card_lattice_3d((4, 8, 32), seed=1)
    f, flags, ztab, args = dk3.kernel_inputs(lat.model, lat.state,
                                             lat.params)
    with pytest.raises(ValueError, match="needs contiguous"):
        dk3.step(f, flags.to(torch.int64), ztab, args)
    with pytest.raises(ValueError, match="needs contiguous"):
        dk3.step2(f.double(), flags, ztab, args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 8, 64), (48, 48, 256)])
def test_d3q27_lattice_engine_matches_eager(card_lattice_3d, shape):
    lat = card_lattice_3d(shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    dk3.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == "cuda_d3q27_band[d3q27_cumulant,fuse=2]"
    assert {k: v for k, v in dk3.LAUNCHES.items() if v} == {
        "d3q27_step2": 5, "d3q27_step": 1}
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    assert lat.get_globals()["Flux"] == pytest.approx(
        ref.get_globals()["Flux"], rel=1e-4, abs=1e-6)


@pytest.fixture
def card_lattice_d3q():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed):
        m = get_model(name)
        lat = Lattice(m, shape, dtype=torch.float32,
                      settings=d3q_family_settings(m), device="cuda")
        return paint_rich_d3q(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 8, 64), (7, 9, 40), (48, 48, 256)])
@pytest.mark.parametrize("name", dk3.KERNELS)
@pytest.mark.parametrize("model", D3Q_FAMILY)
def test_d3q_family_kernel_matches_plain(card_lattice_d3q, model, name,
                                         shape):
    """Each z-slab family model's branch of each kernel on a state that
    paints every node type the model reads, the ragged edge of the 32x8
    columns and 3d_channel's shape."""
    lat = card_lattice_d3q(model, shape, seed=5)
    f, flags, ztab, args = dk3.kernel_inputs(lat.model, lat.state,
                                             lat.params)
    fn, n = dk3.WRAPPERS[name]
    dk3.reset_launches()
    got = fn(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert dk3.LAUNCHES[dk3.launch_key(name, model)] == 1
    assert sum(dk3.LAUNCHES.values()) == 1
    torch.testing.assert_close(got, dk3.plain_steps(f, flags, ztab, args, n),
                               **FIELDS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("model", D3Q_FAMILY)
def test_d3q_family_channel_matches_eager(model):
    """bench.py's 48x48x256 channel: 12 steps on the band engine against
    the eager engine on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    m = get_model(model)
    shape = (48, 48, 256)
    lats = []
    for _ in range(2):
        lat = Lattice(m, shape, dtype=torch.float32, device="cuda",
                      settings={"nu": 0.01, "GravitationX": 1e-5})
        lat.set_flags(channel3d_flags(m, *shape))
        lat.init()
        lats.append(lat)
    lat, ref = lats
    dk3.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == f"cuda_d3q27_band[{model},fuse=2]"
    assert {k: v for k, v in dk3.LAUNCHES.items() if v} == {
        f"d3q27_step2[{model}]": 5, f"d3q27_step[{model}]": 1}
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)


@pytest.fixture
def card_lattice_kuper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(shape, seed):
        lat = Lattice(get_model("d2q9_kuper"), shape, dtype=torch.float32,
                      settings=KUPER_SETTINGS, device="cuda")
        return paint_rich_kuper(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128), (37, 53), (128, 128),
                                   (1024, 1024)])
@pytest.mark.parametrize("name", gk.KERNELS)
def test_generic_kernel_matches_plain(card_lattice_kuper, name, shape):
    """Every d2q9_kuper node type, the ragged edge of the 30x14 tiles
    (37x53), drop.xml's and bench.py's shapes."""
    lat = card_lattice_kuper(shape, seed=5)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    fn, n = gk.WRAPPERS[name]
    gk.reset_launches()
    got = fn(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES[name] == 1
    torch.testing.assert_close(got, gk.plain_steps(f, flags, ztab, args, n),
                               **FIELDS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128), (37, 53), (1024, 1024)])
def test_generic_globals_flavour_matches_plain(card_lattice_kuper, shape):
    lat = card_lattice_kuper(shape, seed=7)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gk.reset_launches()
    got, g = gk.step_globals(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert gk.FLAVOUR_LAUNCHES == {"plain": 0, "globals": 1}
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    assert abs(float(g[1])) > 0
    # a fixed order of summation: the same inputs give the same bits
    assert torch.equal(gk.step_globals(f, flags, ztab, args)[1], g)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,engine", [
    ((128, 128), "cuda_generic_resident[d2q9_kuper,fuse=N]"),
    ((1024, 1024), "cuda_generic_band[d2q9_kuper,fuse=1]"),
])
def test_generic_lattice_engine_matches_eager(card_lattice_kuper, shape,
                                              engine):
    lat = card_lattice_kuper(shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    gk.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == engine and lat.eager_steps == 0
    assert gk.FLAVOUR_LAUNCHES["globals"] == 1
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    got, want = lat.get_globals(), ref.get_globals()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


@pytest.fixture
def card_lattice_heat():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(shape, seed):
        lat = Lattice(get_model("d2q9_heat_adj"), shape,
                      dtype=torch.float32, settings=HEAT_SETTINGS,
                      device="cuda")
        return paint_rich_heat(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64), (37, 53), (512, 1024)])
@pytest.mark.parametrize("name", gk.KERNELS)
def test_heat_adj_kernel_matches_plain(card_lattice_heat, name, shape):
    """d2q9_heat_adj's build of the generic kernels (one stage, no ring):
    every node type the model reads, the ragged edge of the 32x16 tiles
    (37x53), heat_adj.xml's and bench.py's shapes."""
    lat = card_lattice_heat(shape, seed=5)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    fn, n = gk.WRAPPERS[name]
    gk.reset_launches()
    got = fn(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES[name] == 1
    torch.testing.assert_close(got, gk.plain_steps(f, flags, ztab, args, n),
                               **FIELDS_TOL)
    assert torch.equal(got[18], f[18])     # w carried through
    got, g = gk.step_globals(f, flags, ztab, args)
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64), (37, 53), (512, 1024)])
def test_step_b_matches_plain(card_lattice_heat, shape):
    """generic2d_step_b against torch.func.vjp of the plain step: lam_in
    at rtol 1e-4 / atol 1e-6, the settings cotangent at rtol 1e-4."""
    lat = card_lattice_heat(shape, seed=6)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    lam = torch.randn(f.shape, generator=gen, device="cuda")
    lam_g = torch.randn((lat.model.n_globals,), generator=gen,
                        device="cuda")
    ak.reset_launches()
    got, gs = ak.step_b(f, flags, ztab, args, lam, lam_g)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == {"generic2d_step_b": 1, "generic3d_step_b": 0}
    want, ws = ak.step_b_plain(f, flags, ztab, args, lam, lam_g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=0.0)
    # a fixed order of summation: the same inputs give the same bits
    assert torch.equal(ak.step_b(f, flags, ztab, args, lam, lam_g)[1], gs)


@pytest.mark.cuda
def test_kernel_gradient_matches_eager(card_lattice_heat):
    """An 8-step gradient on cuda_adjoint against the eager step's
    autograd on the card, f32: rtol 1e-4 / atol 1e-7
    (tests/test_pallas_adjoint.py:155)."""
    from tclb_tpu_torch.adjoint import InternalTopology, \
        make_unsteady_gradient
    lat = card_lattice_heat((32, 64), seed=7)
    design = InternalTopology(lat.model)
    theta = design.get(lat.state, lat.params)
    runs = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(lat.model, design, 8, levels=1,
                                    engine=engine, shape=lat.shape,
                                    device="cuda")
        runs[engine] = fn(theta, lat.state, lat.params)
    assert fn.engine_name == "eager"
    (oc, gc, _), (oe, ge, _) = runs["cuda"], runs["eager"]
    assert float(oc) == pytest.approx(float(oe), rel=1e-5)
    assert float(ge.abs().max()) > 0
    torch.testing.assert_close(gc, ge, rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_heat_adj_golden_on_the_card(tmp_path):
    """tests/goldens/heat_adj.json in f32 on the card, gradient columns
    on cuda_adjoint, against the f64 recording at rtol 1e-4 / atol 1e-6."""
    import json
    import pathlib
    import xml.etree.ElementTree as ET
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from tclb_tpu_torch.control.solver import _run_root
    root = pathlib.Path(__file__).resolve().parents[1]
    src = (root / "tests" / "test_golden.py").read_text()
    start = src.index('HEAT_ADJ = """') + len('HEAT_ADJ = """')
    xml = src[start:src.index('"""', start)].format(out=tmp_path)
    s = _run_root(ET.fromstring(xml), get_model("d2q9_heat_adj"), None,
                  torch.float32, str(tmp_path) + "/", "heat_adj",
                  device="cuda")
    row = s.log_row()
    fields = s.lattice.state.fields.double().cpu().numpy()
    row["FieldsL1"] = float(abs(fields).sum())
    row["FieldsSum"] = float(fields.sum())
    cols, engine = heat_adj_golden_columns(s)
    assert engine == "cuda_adjoint[d2q9_heat_adj,k=1]"
    row.update(cols)
    golden = json.loads((root / "tests" / "goldens" / "heat_adj.json")
                        .read_text())
    for key, want in golden.items():
        if key != "Walltime":
            assert abs(row[key] - want) <= 1e-6 + 1e-4 * abs(want), key


@pytest.fixture
def card_lattice_adj3d():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(shape, seed):
        lat = Lattice(get_model("d3q19_adj"), shape, dtype=torch.float32,
                      settings=ADJ3D_SETTINGS, device="cuda")
        return paint_rich_adj3d(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32), (5, 11, 37), (32, 64, 256)])
def test_generic3d_step_matches_plain(card_lattice_adj3d, shape):
    """d3q19_adj's generic3d_step, both flavours: every node type the
    model reads, ragged 32x8 blocks (5x11x37), bench.py's shape; fields
    at rtol 2e-5 / atol 2e-6, globals at rtol 1e-4 / atol 1e-6."""
    lat = card_lattice_adj3d(shape, seed=5)
    f, flags, ztab, args = g3.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    g3.reset_launches()
    got = g3.step(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert g3.LAUNCHES == {"generic3d_step": 1}
    torch.testing.assert_close(got, g3.plain_steps(f, flags, ztab, args, 1),
                               **FIELDS_TOL)
    assert torch.equal(got[19], f[19])     # w carried through
    got, g = g3.step_globals(f, flags, ztab, args)
    assert g3.FLAVOUR_LAUNCHES == {"plain": 1, "globals": 1}
    want, wg = g3.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    # a fixed order of summation: the same inputs give the same bits
    assert torch.equal(g3.step_globals(f, flags, ztab, args)[1], g)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32), (5, 11, 37), (32, 64, 256)])
def test_generic3d_step_b_matches_plain(card_lattice_adj3d, shape):
    """generic3d_step_b against torch.func.vjp of the plain step: lam_in
    at rtol 1e-4 / atol 1e-6, the settings cotangent at rtol 1e-4."""
    lat = card_lattice_adj3d(shape, seed=6)
    f, flags, ztab, args = g3.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    lam = torch.randn(f.shape, generator=gen, device="cuda")
    lam_g = torch.randn((lat.model.n_globals,), generator=gen,
                        device="cuda")
    ak.reset_launches()
    got, gs = ak.step_b(f, flags, ztab, args, lam, lam_g)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == {"generic2d_step_b": 0, "generic3d_step_b": 1}
    want, ws = ak.step_b_plain(f, flags, ztab, args, lam, lam_g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=0.0)
    assert torch.equal(ak.step_b(f, flags, ztab, args, lam, lam_g)[1], gs)


@pytest.mark.cuda
def test_adj3d_kernel_gradient_matches_eager():
    """An 8-step gradient on cuda_adjoint3d against the eager step's
    autograd on the card, f32, on bench.py:bench_adjoint3d's case at
    8x16x64: rtol 1e-4 / atol 1e-7 (tests/test_pallas_adjoint.py:155)."""
    from tclb_tpu_torch.adjoint import InternalTopology, \
        make_unsteady_gradient
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    m = get_model("d3q19_adj")
    lat = bench_adjoint3d_lattice(Lattice, m, torch.float32, (8, 16, 64),
                                  device="cuda")
    design = InternalTopology(m)
    theta = torch.full_like(design.get(lat.state, lat.params), 0.8)
    runs = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(m, design, 8, levels=1, engine=engine,
                                    shape=lat.shape, device="cuda")
        runs[engine] = fn(theta, lat.state, lat.params)
        assert fn.engine_name == ("cuda_adjoint3d[d3q19_adj,k=1]"
                                  if engine == "cuda" else "eager")
    (oc, gc, _), (oe, ge, _) = runs["cuda"], runs["eager"]
    assert float(oc) == pytest.approx(float(oe), rel=1e-5)
    assert float(ge.abs().max()) > 0
    torch.testing.assert_close(gc, ge, rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------------------- #
# <Control> time series flavours and d2q9 on the generic kernels
# --------------------------------------------------------------------------- #

# model -> (settings, painter, kernel module) of the rich states with a
# series on two zones (horizon RICH_SERIES_T, so the iteration wraps)
SERIES_CASES = {"d2q9": (RICH_SETTINGS, paint_rich, gk),
                "d2q9_kuper": (KUPER_SETTINGS, paint_rich_kuper, gk),
                "d3q19_adj": (ADJ3D_SETTINGS, paint_rich_adj3d, g3)}


@pytest.fixture
def card_series_lattice():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed):
        settings, paint, _ = SERIES_CASES[name]
        lat = Lattice(get_model(name), shape, dtype=torch.float32,
                      settings=settings, device="cuda")
        return add_rich_series(paint(lat, seed))
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("d2q9", (32, 64)), ("d2q9", (37, 53)), ("d2q9", (96, 512)),
    ("d2q9_kuper", (16, 128)), ("d3q19_adj", (8, 16, 32)),
    ("d3q19_adj", (5, 11, 37))])
@pytest.mark.parametrize("it", [0, RICH_SERIES_T - 1, 3 * RICH_SERIES_T + 2])
def test_series_flavours_match_plain(card_series_lattice, name, shape, it):
    """Both series flavours of generic2d_step / generic3d_step at an
    iteration inside, at the end of and past the horizon: fields at rtol
    2e-5 / atol 2e-6, globals at rtol 1e-4 / atol 1e-6, one launch each."""
    mod = SERIES_CASES[name][2]
    lat = card_series_lattice(name, shape, seed=5)
    f, flags, ztab, args = mod.kernel_inputs(lat.model, lat.state,
                                             lat.params)
    series = gk.series_inputs(lat.model, lat.params)
    mod.reset_launches()
    got = mod.step_series(f, flags, ztab, args, series, it)
    gotg, g = mod.step_series_globals(f, flags, ztab, args, series, it)
    torch.cuda.synchronize()
    assert set(mod.SERIES_LAUNCHES.values()) == {1}
    assert sum(mod.LAUNCHES.values()) == 0
    want, wg = mod.plain_steps(f, flags, ztab, args, 1, with_globals=True,
                               series=series, it=it)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(gotg, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    # the series is read: the plain step on the zone table differs
    assert not torch.equal(got, mod.step(f, flags, ztab, args))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,engine", [
    ("d2q9", (96, 512), "cuda_generic_band[d2q9,fuse=1]"),
    ("d2q9_kuper", (128, 128), "cuda_generic_band[d2q9_kuper,fuse=1]"),
    ("d3q19_adj", (8, 16, 32), "cuda_generic3d_band[d3q19_adj,fuse=1]"),
])
def test_series_lattice_engine_matches_eager(card_series_lattice, name,
                                             shape, engine):
    """Lattice.iterate under a series on the card: the band engine (the
    resident engine and K1/K2 reject a series), 12 steps on the series
    flavours, no eager step, the state and globals of 12 eager steps."""
    mod = SERIES_CASES[name][2]
    lat = card_series_lattice(name, shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    mod.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == engine and lat.eager_steps == 0
    assert list(mod.SERIES_LAUNCHES.values()) == [11, 1]
    assert sum(mod.LAUNCHES.values()) == 0
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    got, want = lat.get_globals(), ref.get_globals()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64), (37, 53), (96, 512)])
def test_d2q9_generic_kernels_match_plain(card_lattice, shape):
    """d2q9's build of the generic kernels (csrc/models/d2q9.cuh) without
    a series: generic2d_step in both flavours and an 8-step
    generic2d_resident on the rich state; the BC planes carried through."""
    lat = card_lattice(shape, seed=5)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gk.reset_launches()
    for name in gk.KERNELS:
        fn, n = gk.WRAPPERS[name]
        got = fn(f, flags, ztab, args)
        torch.testing.assert_close(
            got, gk.plain_steps(f, flags, ztab, args, n), **FIELDS_TOL)
        assert torch.equal(got[9:], f[9:])
    got, g = gk.step_globals(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"generic2d_step": 2, "generic2d_resident": 1}
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    assert bool((g != 0).all())
