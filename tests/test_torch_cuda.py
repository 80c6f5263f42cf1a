"""The d2q9 (with the d2q9 family's branches), d3q27 (with the z-slab
family's branches), generic (2D and 3D, with their <Control> series
flavours; the 2D ones for every model with a device header, the one-stage,
multi-stage and adjoint models among them) and adjoint CUDA kernels
against their plain PyTorch versions on the card, and the storage
ladder's bf16 flavours of the generic 2D and d3q27 kernels with the
precision harness on them.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, so on such a machine run it
without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from tclb_tpu_torch import Lattice, get_model
from tclb_tpu_torch.ops import d2q9_kernels as dk
from tclb_tpu_torch.ops import d3q27_kernels as dk3
from tclb_tpu_torch.ops import adjoint_kernels as ak
from tclb_tpu_torch.ops import generic3d_kernels as g3
from tclb_tpu_torch.ops import generic_kernels as gk
from torch_cases import (ADJ3D_SETTINGS, ADJ_MODELS, ADJ_SERIES,
                         D3Q_FAMILY, FAMILY_MODELS, GENERIC3D_MODELS,
                         HEAT_SETTINGS, RICH_GENERIC3D_SETTINGS,
                         paint_rich_generic3d,
                         KUPER_SETTINGS, MULTISTAGE_MODELS, ONESTAGE_MODELS,
                         RICH3D_SETTINGS, RICH_ADJ_SETTINGS,
                         RICH_MULTISTAGE_SETTINGS, RICH_ONESTAGE_SETTINGS,
                         RICH_SERIES_T, RICH_SETTINGS, add_rich_series,
                         adj_channel, bench_adjoint3d_lattice,
                         channel3d_flags, d3q_family_settings,
                         family_settings, heat_adj_golden_columns,
                         paint_rich, paint_rich_3d, paint_rich_adj,
                         paint_rich_adj3d, paint_rich_d3q, paint_rich_family,
                         paint_rich_heat, paint_rich_kuper,
                         paint_rich_multistage, paint_rich_onestage)

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
    assert gk.flavours() == {"plain": 0, "globals": 1}
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
    assert gk.flavours()["globals"] == 1
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
    assert {k: v for k, v in gk.LAUNCHES.items() if v} == {
        "generic2d_step": 2, "generic2d_resident": 1}
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    assert bool((g != 0).all())


# --------------------------------------------------------------------------- #
# The one-stage 2D models on the generic kernels
# --------------------------------------------------------------------------- #


@pytest.fixture
def card_onestage():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed, **kw):
        lat = Lattice(get_model(name), shape, dtype=torch.float32,
                      settings=RICH_ONESTAGE_SETTINGS[name], device="cuda",
                      **kw)
        return paint_rich_onestage(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64), (37, 53), (256, 256)])
@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_onestage_kernels_match_plain(card_onestage, name, shape):
    """Each one-stage model's build (csrc/models/<model>.cuh): every node
    type its header reads, two zones, the ragged edge of the 32x16 tiles
    (37x53).  generic2d_step in both flavours against the plain version
    (the globals at rtol 1e-4 / atol 1e-6), an 8-step generic2d_resident
    against it and, bit for bit, against eight generic2d_step launches."""
    lat = card_onestage(name, shape, seed=5)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gk.reset_launches()
    got = gk.step(f, flags, ztab, args)
    torch.testing.assert_close(got, gk.plain_steps(f, flags, ztab, args, 1),
                               **FIELDS_TOL)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(gotg, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    torch.testing.assert_close(res, gk.plain_steps(f, flags, ztab, args, 8),
                               **FIELDS_TOL)
    torch.cuda.synchronize()
    assert {k: v for k, v in gk.LAUNCHES.items() if v} == {
        "generic2d_step": 2, "generic2d_resident": 1}
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    assert torch.equal(res, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,engine", [
    ((64, 64), "cuda_generic_resident[{},fuse=N]"),
    ((512, 1024), "cuda_generic_band[{},fuse=1]"),
])
@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_onestage_lattice_engine_matches_eager(card_onestage, name, shape,
                                               engine):
    """Lattice.iterate on the card takes the resident engine where the
    lattice fits half the L2, else the band engine, runs no eager step,
    and its 12 steps and globals match 12 eager steps."""
    lat = card_onestage(name, shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    gk.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == engine.format(name) and lat.eager_steps == 0
    assert gk.flavours()["globals"] == 1
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    got, want = lat.get_globals(), ref.get_globals()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


@pytest.mark.cuda
def test_heat_series_flavours_match_plain(card_onestage):
    """d2q9_heat under a <Control> series of HeaterTemperature on zone 0,
    the Heater patch's (horizon 5): both series flavours of
    generic2d_step against their plain versions, at an iteration inside
    the horizon and one past it."""
    lat = card_onestage("d2q9_heat", (37, 53), seed=4)
    lat.set_setting_series("HeaterTemperature", [1.5, 1.8, 2.2, 2.0, 1.6],
                           zone=0)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    series = gk.series_inputs(lat.model, lat.params)
    gk.reset_launches()
    for it in (2, 13):
        got = gk.step_series(f, flags, ztab, args, series, it)
        torch.testing.assert_close(got, gk.plain_steps(
            f, flags, ztab, args, 1, series=series, it=it), **FIELDS_TOL)
        got, g = gk.step_series_globals(f, flags, ztab, args, series, it)
        want, wg = gk.plain_steps(f, flags, ztab, args, 1,
                                  with_globals=True, series=series, it=it)
        torch.testing.assert_close(got, want, **FIELDS_TOL)
        torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    assert gk.SERIES_LAUNCHES == {"generic2d_step_series": 2,
                                  "generic2d_step_series_globals": 2}
    assert not torch.equal(gk.step_series(f, flags, ztab, args, series, 2),
                           gk.step_series(f, flags, ztab, args, series, 3))


# --------------------------------------------------------------------------- #
# The storage ladder: the bf16 flavours of K4, K5 and K3
# --------------------------------------------------------------------------- #

from tclb_tpu_torch import precision  # noqa: E402
from tclb_tpu_torch.core import shift as ddf  # noqa: E402

# model -> (settings, painter) of the rich bf16 states
BF16_GENERIC = {"d2q9": (RICH_SETTINGS, paint_rich),
                "d2q9_kuper": (KUPER_SETTINGS, paint_rich_kuper),
                "d2q9_heat_adj": (HEAT_SETTINGS, paint_rich_heat)}


def _raw(lat_or_model, fields, storage_repr):
    """A bf16 stack widened to f32 in the raw representation."""
    model = getattr(lat_or_model, "model", lat_or_model)
    return ddf.widen_stack(fields, torch.float32,
                           ddf.stack_shift(model, storage_repr))


def _assert_narrowed(got, wide, model, storage_repr):
    """A bf16 kernel's output against its plain version's compute values
    before their one narrowing (``wide``, raw f32): the f32 tolerance
    carried through the narrowing (``core/shift.py:narrowed_bounds``).
    Where the kernel's f32 arithmetic equals the plain version's, this is
    bit-equality with the narrowed plain output; where it sits an ulp
    away, a value that straddles a bf16 rounding boundary may round to its
    other neighbour, and only then."""
    lo, hi = ddf.narrowed_bounds(wide, torch.bfloat16,
                                 ddf.stack_shift(model, storage_repr),
                                 **FIELDS_TOL)
    s = got.double()
    bad = (s < lo.double()) | (s > hi.double())
    assert not bool(bad.any()), (
        f"{int(bad.sum())} values outside the f32 tolerance carried "
        "through the narrowing")


def _wide_plain(mod, f, flags, ztab, args, n, model, storage_repr):
    """The plain version's f32 values before its one narrowing: ``n``
    plain f32 steps on the widened stack (K4: n = 1; K3: the kernel's
    cadence)."""
    wide = ddf.widen_stack(f, torch.float32,
                           ddf.stack_shift(model, storage_repr))
    f32_args = dataclasses.replace(args, shift=None)
    return mod.plain_steps(wide, flags, ztab, f32_args, n)


@pytest.fixture
def card_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, storage_repr, seed):
        m = get_model(name)
        if name in BF16_GENERIC:
            settings, paint = BF16_GENERIC[name]
        elif name == "d3q27_cumulant":
            settings, paint = RICH3D_SETTINGS, paint_rich_3d
        else:
            settings, paint = d3q_family_settings(m), paint_rich_d3q
        lat = Lattice(m, shape, dtype=torch.float32, settings=settings,
                      device="cuda", storage_dtype=torch.bfloat16,
                      storage_repr=storage_repr)
        return paint(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("shape", [(16, 128), (37, 53), (64, 64)])
@pytest.mark.parametrize("name", sorted(BF16_GENERIC))
def test_bf16_generic_kernels_match_plain(card_bf16, name, shape,
                                          storage_repr):
    """generic2d_step_bf16 (both flavours) against the narrowed eager step
    on the same bf16 stack (the f32 tolerance carried through the one
    narrowing; the globals at rtol 1e-4 / atol 1e-6), and an 8-step
    generic2d_resident_bf16 against eight generic2d_step_bf16 launches, bit
    for bit (the same device code a step), and, for the models whose f32
    kernels equal their plain versions bit for bit, against the plain
    version at the f32 tolerance."""
    lat = card_bf16(name, shape, storage_repr, seed=5)
    m = lat.model
    shift = ddf.kernel_shift(m, storage_repr)
    f, flags, ztab, args = gk.kernel_inputs(m, lat.state, lat.params, shift)
    assert f.dtype == torch.bfloat16
    gk.reset_launches()
    got = gk.step(f, flags, ztab, args)
    assert got.dtype == torch.bfloat16
    wide = _wide_plain(gk, f, flags, ztab, args, 1, m, storage_repr)
    _assert_narrowed(got, wide, m, storage_repr)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    _assert_narrowed(gotg, wide, m, storage_repr)
    _, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    torch.cuda.synchronize()
    assert {k: v for k, v in gk.LAUNCHES.items() if v} == {
        "generic2d_step_bf16": 2, "generic2d_resident_bf16": 1}
    assert gk.flavours("generic2d_step_bf16") == {"plain": 1, "globals": 1}
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    assert torch.equal(res.view(torch.int16), steps.view(torch.int16))
    if name != "d2q9":      # d2q9's header sums rho in plane order
        torch.testing.assert_close(
            _raw(lat, res, storage_repr),
            _raw(lat, gk.plain_steps(f, flags, ztab, args, 8), storage_repr),
            **FIELDS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("shape", [(12, 8, 64), (7, 9, 40)])
@pytest.mark.parametrize("model", ("d3q27_cumulant",) + D3Q_FAMILY)
def test_bf16_d3q27_kernels_match_plain(card_bf16, model, shape,
                                        storage_repr):
    """d3q27_step_bf16 and d3q27_step2_bf16 against the narrowed eager
    steps at their cadence (one step; two f32 steps between one widen and
    one narrow): the f32 tolerance carried through the one narrowing, the
    cumulant's SynthT planes carried through."""
    lat = card_bf16(model, shape, storage_repr, seed=5)
    m = lat.model
    f, flags, ztab, args = dk3.kernel_inputs(
        m, lat.state, lat.params, ddf.kernel_shift(m, storage_repr))
    dk3.reset_launches()
    for name in dk3.KERNELS:
        fn, n = dk3.WRAPPERS[name]
        got = fn(f, flags, ztab, args)
        assert got.dtype == torch.bfloat16
        _assert_narrowed(got, _wide_plain(dk3, f, flags, ztab, args, n, m,
                                          storage_repr), m, storage_repr)
        if model == "d3q27_cumulant":
            assert torch.equal(got[27:30], f[27:30])
    torch.cuda.synchronize()
    assert {k: v for k, v in dk3.LAUNCHES.items() if v} == {
        dk3.launch_key(k, model): 1 for k in dk3.BF16_KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name,shape,engine", [
    ("d2q9", (64, 64), "cuda_generic_resident[d2q9,fuse=N,bfloat16/{}]"),
    ("d2q9", (1024, 1024), "cuda_generic_band[d2q9,fuse=1,bfloat16/{}]"),
    ("d2q9_kuper", (64, 64),
     "cuda_generic_resident[d2q9_kuper,fuse=N,bfloat16/{}]"),
    ("d2q9_kuper", (1024, 1024),
     "cuda_generic_band[d2q9_kuper,fuse=1,bfloat16/{}]"),
])
def test_bf16_generic_lattice_matches_eager(card_bf16, name, shape, engine,
                                            storage_repr):
    """Lattice.iterate on a bf16 lattice on the card selects the generic
    engine (K1/K2 reject bf16), with the storage in its tag: its 12 steps
    equal 12 generic2d_step_bf16 launches bit for bit and, where the f32
    kernels equal their plain versions bit for bit (d2q9_kuper), 12
    narrowed eager steps (both narrow once a step)."""
    lat = card_bf16(name, shape, storage_repr, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda",
                  storage_dtype=torch.bfloat16, storage_repr=storage_repr)
    ref.set_state(lat.state, lat.params)
    f, flags, ztab, args = gk.kernel_inputs(
        lat.model, lat.state, lat.params,
        ddf.kernel_shift(lat.model, storage_repr))
    gk.reset_launches()
    lat.iterate(12)
    assert lat.engine_name == engine.format(storage_repr)
    assert lat.eager_steps == 0
    assert gk.flavours("generic2d_step_bf16")["globals"] == 1
    assert not any(gk.LAUNCHES[k] for k in gk.KERNELS)
    for _ in range(12):
        f = gk.step(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert torch.equal(lat.state.fields.view(torch.int16),
                       f.view(torch.int16))
    if name != "d2q9":      # d2q9's header sums rho in plane order
        ref.state = ref._iterate(ref.state, ref.params, 12)
        torch.testing.assert_close(
            _raw(lat, lat.state.fields, storage_repr),
            _raw(lat, ref.state.fields, storage_repr), **FIELDS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ("d3q27_cumulant", "d3q19"))
def test_bf16_d3q27_lattice_engine(card_bf16, model):
    """A bf16 shifted z-slab lattice on the card: the K3 band engine with
    the storage in its tag, its launches the bf16 flavours only."""
    lat = card_bf16(model, (12, 8, 64), "shifted", seed=6)
    dk3.reset_launches()
    lat.iterate(12)
    torch.cuda.synchronize()
    assert lat.engine_name == (f"cuda_d3q27_band[{model},fuse=2,"
                               "bfloat16/shifted]")
    assert {k: v for k, v in dk3.LAUNCHES.items() if v} == {
        dk3.launch_key("d3q27_step2_bf16", model): 5,
        dk3.launch_key("d3q27_step_bf16", model): 1}
    assert bool(torch.isfinite(lat.state.fields.float()).all())


@pytest.mark.cuda
def test_bf16_rejected_engines_run_eager_by_selection():
    """K6 and the series flavours have no bf16 rung: a bf16 lattice there
    runs eager by selection, with the storage in the tag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    lat = Lattice(get_model("d3q19_adj"), (8, 16, 32), device="cuda",
                  settings=ADJ3D_SETTINGS, storage_dtype=torch.bfloat16)
    assert lat.engine_name == "eager[bfloat16/shifted]"
    lat = Lattice(get_model("d2q9"), (32, 64), device="cuda",
                  settings=RICH_SETTINGS, storage_dtype=torch.bfloat16)
    lat.set_setting_series("Velocity", [0.01, 0.02], zone=0)
    assert lat.engine_name == "eager[bfloat16/shifted]"


@pytest.mark.cuda
@pytest.mark.parametrize("case", precision.CASE_NAMES)
def test_bf16_harness_within_bounds_on_the_kernels(case):
    """The precision harness on the card: both representations of the
    case at 64x64 and 500 steps on the generic resident engine, within
    ERROR_BOUNDS; the shifted cavity's u_linf at least 10x below raw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    raw, shifted = precision.compare_reprs(case, device="cuda")
    for rep in (raw, shifted):
        assert rep["engine"].startswith("cuda_generic_resident["), rep
        assert precision.check_bounds(rep) == []
        assert all(r["l2"] > 0 for r in rep["checkpoints"])
    if case == "cavity":
        for rr, rs in zip(raw["checkpoints"], shifted["checkpoints"]):
            assert rs["u_linf"] <= rr["u_linf"] / 10, (rr, rs)


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_the_card(tmp_path):
    """A bf16 shifted lattice on the card saves and loads bit-exactly, and
    through a raw f32 lattice stays within the f32 rounding of f + w."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    sh = precision.case_lattice("cavity", 32, torch.bfloat16, "shifted",
                                "cuda")
    sh.iterate(12)
    sh.save(str(tmp_path / "sh.npz"))
    same = precision.case_lattice("cavity", 32, torch.bfloat16, "shifted",
                                  "cuda")
    same.load(str(tmp_path / "sh.npz"))
    assert torch.equal(same.state.fields.view(torch.int16),
                       sh.state.fields.view(torch.int16))
    wide = precision.case_lattice("cavity", 32, device="cuda")
    wide.load(str(tmp_path / "sh.npz"))
    assert abs(wide.fields_raw() - sh.fields_raw()).max() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name", ONESTAGE_MODELS)
def test_onestage_bf16_kernels_match_plain(card_onestage, name,
                                           storage_repr):
    """generic2d_step_bf16 (both flavours) against the narrowed eager step
    on the same bf16 stack (the f32 tolerance carried through the one
    narrowing; the globals at rtol 1e-4 / atol 1e-6), an 8-step
    generic2d_resident_bf16 bit for bit against eight generic2d_step_bf16
    launches."""
    lat = card_onestage(name, (37, 53), seed=5,
                        storage_dtype=torch.bfloat16,
                        storage_repr=storage_repr)
    m = lat.model
    shift = ddf.kernel_shift(m, storage_repr)
    f, flags, ztab, args = gk.kernel_inputs(m, lat.state, lat.params, shift)
    assert f.dtype == torch.bfloat16
    wide = _wide_plain(gk, f, flags, ztab, args, 1, m, storage_repr)
    _assert_narrowed(gk.step(f, flags, ztab, args), wide, m, storage_repr)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    _assert_narrowed(gotg, wide, m, storage_repr)
    _, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    torch.cuda.synchronize()
    assert torch.equal(res.view(torch.int16), steps.view(torch.int16))


# --------------------------------------------------------------------------- #
# The multi-stage 2D models: K4 and K5 on plans of two and three stages
# --------------------------------------------------------------------------- #


@pytest.fixture
def card_multistage():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed, **kw):
        lat = Lattice(get_model(name), shape, dtype=torch.float32,
                      settings=RICH_MULTISTAGE_SETTINGS[name], device="cuda",
                      **kw)
        return paint_rich_multistage(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64), (37, 53), (256, 256)])
@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_multistage_kernels_match_plain(card_multistage, name, shape):
    """Each multi-stage model's build: every node type its header reads,
    two zones, ragged tiles (37x53).  generic2d_step (one launch, the
    ring form or the staged form) in both flavours against the plain
    version (the globals at rtol 1e-4 / atol 1e-6), an 8-step
    generic2d_resident against it and, bit for bit, against eight
    generic2d_step calls."""
    lat = card_multistage(name, shape, seed=5)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gk.reset_launches()
    got = gk.step(f, flags, ztab, args)
    torch.testing.assert_close(got, gk.plain_steps(f, flags, ztab, args, 1),
                               **FIELDS_TOL)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(gotg, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    torch.testing.assert_close(res, gk.plain_steps(f, flags, ztab, args, 8),
                               **FIELDS_TOL)
    torch.cuda.synchronize()
    # a two-stage plan with a ring of two and three stages, each in one
    # launch
    assert {k: v for k, v in gk.LAUNCHES.items() if v} == {
        "generic2d_step": 2, "generic2d_resident": 1}
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    assert torch.equal(res, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,engine", [
    ((64, 128), "cuda_generic_resident[{},fuse=N]"),
    ((512, 1024), "cuda_generic_band[{},fuse=1]"),
])
@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_multistage_lattice_engine_matches_eager(card_multistage, name,
                                                 shape, engine):
    """Lattice.iterate on the card takes the resident engine where the
    lattice fits half the L2, else the band engine, runs no eager step, and
    its 12 steps and globals match 12 eager steps."""
    lat = card_multistage(name, shape, seed=6)
    ref = Lattice(lat.model, shape, dtype=torch.float32, device="cuda")
    ref.set_state(lat.state, lat.params)
    gk.reset_launches()
    lat.iterate(12)
    ref.state = ref._iterate(ref.state, ref.params, 12)
    torch.cuda.synchronize()
    assert lat.engine_name == engine.format(name) and lat.eager_steps == 0
    assert gk.flavours()["globals"] == 1
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               **FIELDS_TOL)
    got, want = lat.get_globals(), ref.get_globals()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


@pytest.mark.cuda
@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name", MULTISTAGE_MODELS)
def test_multistage_bf16_kernels_match_plain(card_multistage, name,
                                             storage_repr):
    """generic2d_step_bf16 (both flavours) against the narrowed eager step
    on the same bf16 stack (the earlier stages' planes stay f32: one
    narrowing a step), an 8-step generic2d_resident_bf16 bit for bit
    against eight generic2d_step_bf16 calls."""
    lat = card_multistage(name, (37, 53), seed=5,
                          storage_dtype=torch.bfloat16,
                          storage_repr=storage_repr)
    m = lat.model
    shift = ddf.kernel_shift(m, storage_repr)
    f, flags, ztab, args = gk.kernel_inputs(m, lat.state, lat.params, shift)
    assert f.dtype == torch.bfloat16
    wide = _wide_plain(gk, f, flags, ztab, args, 1, m, storage_repr)
    _assert_narrowed(gk.step(f, flags, ztab, args), wide, m, storage_repr)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    _assert_narrowed(gotg, wide, m, storage_repr)
    _, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    torch.cuda.synchronize()
    assert torch.equal(res.view(torch.int16), steps.view(torch.int16))


@pytest.mark.cuda
def test_lee_series_flavours_match_plain(card_multistage):
    """d2q9_lee under a <Control> series of InletVelocity on zone 0 (its
    E velocity and W equilibrium faces; horizon 5): both series flavours
    of the three-stage step against their plain versions, at an iteration
    inside the horizon and one past it, each in one launch."""
    lat = card_multistage("d2q9_lee", (37, 53), seed=4)
    lat.set_setting_series("InletVelocity", [0.01, 0.015, 0.02, 0.012,
                                             0.008], zone=0)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    series = gk.series_inputs(lat.model, lat.params)
    gk.reset_launches()
    for it in (2, 13):
        got = gk.step_series(f, flags, ztab, args, series, it)
        torch.testing.assert_close(got, gk.plain_steps(
            f, flags, ztab, args, 1, series=series, it=it), **FIELDS_TOL)
        got, g = gk.step_series_globals(f, flags, ztab, args, series, it)
        want, wg = gk.plain_steps(f, flags, ztab, args, 1,
                                  with_globals=True, series=series, it=it)
        torch.testing.assert_close(got, want, **FIELDS_TOL)
        torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    # two calls of each flavour, one launch a call
    assert gk.SERIES_LAUNCHES == {"generic2d_step_series": 2,
                                  "generic2d_step_series_globals": 2}


STAGED_MODELS = ("d2q9_pp_MCMP", "d2q9_lee", "d2q9_poison_boltzmann")
STAGED_FLAVOURS = ("plain", "globals", "bf16", "bf16 globals", "series",
                   "series globals")


def _step_flavour_matches_plain(lat, flavour: str) -> None:
    """One ``generic2d_step`` call of ``flavour`` on ``lat``'s state
    against its plain version (a series on the first zonal setting in
    zone 0; bf16 on the shifted stack, within the f32 tolerance carried
    through its one narrowing; globals at rtol 1e-4 / atol 1e-6), one
    launch in all."""
    m = lat.model
    name0 = m.zonal_settings[0]
    v = float(lat.params.settings[m.setting_index[name0]])
    lat.set_setting_series(name0, [v, 1.01 * v + 1e-4, v], zone=0)
    f, flags, ztab, args = gk.kernel_inputs(m, lat.state, lat.params)
    series = gk.series_inputs(m, lat.params)
    glob = flavour.endswith("globals")
    gk.reset_launches()
    if flavour.startswith("bf16"):
        shift = ddf.kernel_shift(m, "shifted")
        fb = ddf.narrow_stack(f, torch.bfloat16,
                              ddf.stack_shift(m, "shifted"))
        ab = dataclasses.replace(args, shift=shift)
        got = (gk.step_globals if glob else gk.step)(fb, flags, ztab, ab)
        want = gk.plain_steps(fb, flags, ztab, ab, 1, with_globals=glob)
        wide = _wide_plain(gk, fb, flags, ztab, ab, 1, m, "shifted")
        _assert_narrowed(got[0] if glob else got, wide, m, "shifted")
    elif flavour.startswith("series"):
        fn = gk.step_series_globals if glob else gk.step_series
        got = fn(f, flags, ztab, args, series, 1)
        want = gk.plain_steps(f, flags, ztab, args, 1, with_globals=glob,
                              series=series, it=1)
        torch.testing.assert_close(got[0] if glob else got,
                                   want[0] if glob else want, **FIELDS_TOL)
    else:
        got = (gk.step_globals if glob else gk.step)(f, flags, ztab, args)
        want = gk.plain_steps(f, flags, ztab, args, 1, with_globals=glob)
        torch.testing.assert_close(got[0] if glob else got,
                                   want[0] if glob else want, **FIELDS_TOL)
    if glob:
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    assert sum(gk.LAUNCHES.values()) + sum(gk.SERIES_LAUNCHES.values()) \
        == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64), (37, 70)])
@pytest.mark.parametrize("flavour", STAGED_FLAVOURS)
@pytest.mark.parametrize("name", STAGED_MODELS)
def test_staged_step_flavours_match_plain(card_multistage, name, flavour,
                                          shape):
    """The staged form (generic2d_staged_kernel) in each flavour against
    its plain version, one launch a call and no scratch stack, on a
    lattice fewer rows high than a tile plus its reach (16x64) and on
    ragged tiles (37x70); the globals at rtol 1e-4 / atol 1e-6, the bf16
    step within the f32 tolerance carried through its one narrowing."""
    lat = card_multistage(name, shape, seed=7)
    _step_flavour_matches_plain(lat, flavour)
    assert gk.step_form(lat.model) == "staged"


# the headers of the tiled form (generic2d_tiled_kernel), the narrow pass
# (generic2d_pass_kernel in 32x8 blocks) and the ring form
# (generic2d_step_kernel)
NEW_FORMS = {"d2q9_npe_guo": "tiled", "d2q9_solid": "narrow",
             "d2q9_pf_pressureEvolution": "ring", "d2q9_kuper": "ring"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64), (37, 70), (100, 130)])
@pytest.mark.parametrize("flavour", STAGED_FLAVOURS)
@pytest.mark.parametrize("name", sorted(NEW_FORMS))
def test_tiled_and_ring_step_flavours_match_plain(request, name, flavour,
                                                  shape):
    """The tiled form (npe_guo), the narrow pass (solid) and the ring
    form's tile
    (pf_pressureEvolution, kuper) in each flavour against the plain
    version, one launch a call: on a lattice fewer rows high than a tile
    and its ring (16x64), and on ragged tiles (37x70, 100x130: several
    tiles a side, each thread's second row of the ring form's tile cut
    by the edge); the globals at rtol 1e-4 / atol 1e-6, bf16 within the
    f32 tolerance carried through its one narrowing."""
    if name == "d2q9_kuper":
        lat = request.getfixturevalue("card_lattice_kuper")(shape, seed=7)
    else:
        fixture = ("card_multistage" if NEW_FORMS[name] == "ring"
                   else "card_onestage")
        lat = request.getfixturevalue(fixture)(name, shape, seed=7)
    _step_flavour_matches_plain(lat, flavour)
    assert gk.step_form(lat.model) == NEW_FORMS[name]


# --------------------------------------------------------------------------- #
# the 2D adjoint models: d2q9_adj, d2q9_optimalMixing, d2q9_plate
# --------------------------------------------------------------------------- #


@pytest.fixture
def card_adj():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed, **kw):
        lat = Lattice(get_model(name), shape, dtype=torch.float32,
                      settings=RICH_ADJ_SETTINGS[name], device="cuda", **kw)
        return paint_rich_adj(lat, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64), (37, 53), (256, 256)])
@pytest.mark.parametrize("name", ADJ_MODELS)
def test_adj_models_kernels_match_plain(card_adj, name, shape):
    """Each adjoint model's build: every node type its header reads, two
    zones with different zonal values, ragged 32x16 tiles (37x53).
    generic2d_step in both flavours against the plain version (the
    globals at rtol 1e-4 / atol 1e-6), an 8-step generic2d_resident
    against it and, bit for bit, against eight generic2d_step calls."""
    lat = card_adj(name, shape, seed=5)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    gk.reset_launches()
    got = gk.step(f, flags, ztab, args)
    torch.testing.assert_close(got, gk.plain_steps(f, flags, ztab, args, 1),
                               **FIELDS_TOL)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    want, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(gotg, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    torch.testing.assert_close(res, gk.plain_steps(f, flags, ztab, args, 8),
                               **FIELDS_TOL)
    torch.cuda.synchronize()
    assert {k: v for k, v in gk.LAUNCHES.items() if v} == {
        "generic2d_step": 2, "generic2d_resident": 1}
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    assert torch.equal(res, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64), (37, 53), (256, 256)])
@pytest.mark.parametrize("name", ADJ_MODELS)
def test_adj_models_step_b_matches_plain(card_adj, name, shape):
    """generic2d_step_b, reading the zonal settings from the zone table,
    against torch.func.vjp of the plain step: lam_in at rtol 1e-4 / atol
    1e-6, the settings cotangent at rtol 1e-4."""
    lat = card_adj(name, shape, seed=6)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    assert bool((ztab[:, 0] != ztab[:, 1]).all())
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
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("storage_repr", ddf.STORAGE_REPRS)
@pytest.mark.parametrize("name", ADJ_MODELS)
def test_adj_models_bf16_kernels_match_plain(card_adj, name, storage_repr):
    """generic2d_step_bf16 (both flavours) against the narrowed eager step
    on the same bf16 stack, an 8-step generic2d_resident_bf16 bit for bit
    against eight generic2d_step_bf16 calls."""
    lat = card_adj(name, (37, 53), seed=5, storage_dtype=torch.bfloat16,
                   storage_repr=storage_repr)
    m = lat.model
    shift = ddf.kernel_shift(m, storage_repr)
    f, flags, ztab, args = gk.kernel_inputs(m, lat.state, lat.params, shift)
    assert f.dtype == torch.bfloat16
    wide = _wide_plain(gk, f, flags, ztab, args, 1, m, storage_repr)
    _assert_narrowed(gk.step(f, flags, ztab, args), wide, m, storage_repr)
    gotg, g = gk.step_globals(f, flags, ztab, args)
    _assert_narrowed(gotg, wide, m, storage_repr)
    _, wg = gk.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    res = gk.resident(f, flags, ztab, args, 8)
    steps = f
    for _ in range(8):
        steps = gk.step(steps, flags, ztab, args)
    torch.cuda.synchronize()
    assert torch.equal(res.view(torch.int16), steps.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADJ_MODELS)
def test_adj_models_series_flavours_match_plain(card_adj, name):
    """Both series flavours of each adjoint model's step under a series of
    a zonal setting (horizon 5), at an iteration inside the horizon and
    one past it."""
    lat = card_adj(name, (37, 53), seed=4)
    setting, values = ADJ_SERIES[name]
    lat.set_setting_series(setting, values, zone=0)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state,
                                            lat.params)
    series = gk.series_inputs(lat.model, lat.params)
    gk.reset_launches()
    for it in (2, 13):
        got = gk.step_series(f, flags, ztab, args, series, it)
        torch.testing.assert_close(got, gk.plain_steps(
            f, flags, ztab, args, 1, series=series, it=it), **FIELDS_TOL)
        got, g = gk.step_series_globals(f, flags, ztab, args, series, it)
        want, wg = gk.plain_steps(f, flags, ztab, args, 1,
                                  with_globals=True, series=series, it=it)
        torch.testing.assert_close(got, want, **FIELDS_TOL)
        torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    assert gk.SERIES_LAUNCHES == {"generic2d_step_series": 2,
                                  "generic2d_step_series_globals": 2}


@pytest.mark.cuda
def test_adj_kernel_gradient_matches_eager():
    """tests/test_pallas_adjoint.py:_setup's d2q9_adj channel (16x128): an
    8-step gradient on cuda_adjoint against the eager step's autograd on
    the card, f32: rtol 1e-4 / atol 1e-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from tclb_tpu_torch.adjoint import InternalTopology, \
        make_unsteady_gradient
    m = get_model("d2q9_adj")
    lat = adj_channel(Lattice, m, torch.float32, device="cuda")
    design = InternalTopology(m)
    theta = torch.full_like(design.get(lat.state, lat.params), 0.7)
    runs = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(m, design, 8, levels=1, engine=engine,
                                    shape=lat.shape, device="cuda")
        runs[engine] = fn(theta, lat.state, lat.params)
    (oc, gc, _), (oe, ge, _) = runs["cuda"], runs["eager"]
    assert float(oc) == pytest.approx(float(oe), rel=1e-5)
    assert float(ge.abs().max()) > 0
    torch.testing.assert_close(gc, ge, rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------------------- #
# the 3D models of the generic engine (K6: passes, Field reads)
# --------------------------------------------------------------------------- #


@pytest.fixture
def card_lattice_generic3d():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")

    def make(name, shape, seed):
        lat = Lattice(get_model(name), shape, dtype=torch.float32,
                      settings=RICH_GENERIC3D_SETTINGS[name], device="cuda")
        return paint_rich_generic3d(
            lat, gk.DEVICE_MODELS[name].node_types, seed)
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32), (5, 11, 37)])
@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_generic3d_models_match_plain(card_lattice_generic3d, name, shape):
    """Each 3D model's generic3d_step on a rich state (every node type its
    header reads, two zones, qibb's cuts from a sphere, kuper's phi not
    constant; ragged 32x8 blocks at 5x11x37), all four flavours: one
    launch a stage (kuper: two), fields at rtol 2e-5 / atol 2e-6, globals
    at rtol 1e-4 / atol 1e-6."""
    lat = card_lattice_generic3d(name, shape, seed=5)
    m = lat.model
    passes = len(gk.DEVICE_MODELS[name].plan)
    f, flags, ztab, args = g3.kernel_inputs(m, lat.state, lat.params)
    g3.reset_launches()
    got = g3.step(f, flags, ztab, args)
    torch.cuda.synchronize()
    assert g3.LAUNCHES == {"generic3d_step": passes}
    torch.testing.assert_close(got, g3.plain_steps(f, flags, ztab, args, 1),
                               **FIELDS_TOL)
    got, g = g3.step_globals(f, flags, ztab, args)
    assert g3.FLAVOUR_LAUNCHES == {"plain": passes, "globals": passes}
    want, wg = g3.plain_steps(f, flags, ztab, args, 1, with_globals=True)
    torch.testing.assert_close(got, want, **FIELDS_TOL)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    assert torch.equal(g3.step_globals(f, flags, ztab, args)[1], g)
    zonal = m.zonal_settings[0]
    v = float(lat.params.zone_table[m.setting_index[zonal], 1])
    lat.set_setting_series(zonal, [v * (1 + 0.05 * k) for k in range(5)],
                           zone=1)
    series = gk.series_inputs(m, lat.params)
    f, flags, ztab, args = g3.kernel_inputs(m, lat.state, lat.params)
    for it in (0, 4, 12):
        got = g3.step_series(f, flags, ztab, args, series, it)
        gotg, g = g3.step_series_globals(f, flags, ztab, args, series, it)
        want, wg = g3.plain_steps(f, flags, ztab, args, 1, with_globals=True,
                                  series=series, it=it)
        torch.testing.assert_close(got, want, **FIELDS_TOL)
        torch.testing.assert_close(gotg, want, **FIELDS_TOL)
        torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-6)
    assert g3.SERIES_LAUNCHES == {"generic3d_step_series": 3 * passes,
                                  "generic3d_step_series_globals":
                                      3 * passes}


@pytest.mark.cuda
@pytest.mark.parametrize("name", GENERIC3D_MODELS)
def test_generic3d_models_take_the_band_engine(card_lattice_generic3d,
                                               name):
    """Lattice.iterate on the card picks K6 for each model (the z-slab
    kernels reject them), runs no eager step and agrees with eager f32
    over a few steps."""
    lat = card_lattice_generic3d(name, (8, 16, 32), seed=7)
    ref = card_lattice_generic3d(name, (8, 16, 32), seed=7)
    assert lat.engine_name == f"cuda_generic3d_band[{name},fuse=1]"
    g3.reset_launches()
    lat.iterate(3)
    ref.state = ref._iterate(ref.state, ref.params, 3)
    assert lat.eager_steps == 0
    assert g3.LAUNCHES["generic3d_step"] == 3 * len(
        gk.DEVICE_MODELS[name].plan)
    torch.testing.assert_close(lat.state.fields, ref.state.fields,
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(lat.state.globals_, ref.state.globals_,
                               rtol=1e-4, atol=1e-6)



# --------------------------------------------------------------------------- #
# The resident kernels at tiny and ragged lattices: a tile (generic2d_
# resident) or a block's nodes (d2q9_resident8) wrap onto themselves
# --------------------------------------------------------------------------- #

RESIDENT_SMALL = [(21, 40), (37, 53), (9, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RESIDENT_SMALL + [(5, 7)])
@pytest.mark.parametrize("model", ("d2q9",) + FAMILY_MODELS)
def test_resident8_small_lattices(card_lattice, card_lattice_family, model,
                                  shape):
    """d2q9_resident8 of every build against its plain version at the SRT
    Poiseuille's 21x40, a ragged 37x53 and lattices smaller than a
    block."""
    lat = card_lattice(shape, seed=3) if model == "d2q9" else \
        card_lattice_family(model, shape, seed=3)
    f, flags, vel, den, args = dk.kernel_inputs(lat.model, lat.state,
                                                lat.params)
    dk.reset_launches()
    got = dk.resident8(f, flags, vel, den, args)
    torch.cuda.synchronize()
    assert dk.LAUNCHES[dk.launch_key("d2q9_resident8", model)] == 1
    want = dk.plain_steps(f, flags, vel, den, args, dk.RESIDENT_FUSE)
    torch.testing.assert_close(got, want, **FIELDS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nsteps", [2, 8, 98])
@pytest.mark.parametrize("shape", RESIDENT_SMALL)
@pytest.mark.parametrize("model", ["d2q9_heat", "d2q9_kuper",
                                   "d2q9_pf_pressureEvolution", "d2q9_lee",
                                   "d2q9_poison_boltzmann", "d2q9_npe_guo"])
def test_resident_small_lattices(model, shape, nsteps):
    """generic2d_resident (two steps a wait for the one-stage plans and
    d2q9_kuper, one for the others) and its bf16 flavour bit for bit as
    many chained generic2d_step and generic2d_step_bf16 launches, where a
    tile's ring wraps onto the tile and onto one neighbour twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    from tclb_tpu_torch.ops import generic2d_parity as gp
    lat = gp.paint(get_model(model), shape, seed=4)
    f, flags, ztab, args = gk.kernel_inputs(lat.model, lat.state, lat.params)
    fb, ab = gp.bf16_inputs(lat, f, args)
    for x, a in ((f, args), (fb, ab)):
        chain = x
        for _ in range(nsteps):
            chain = gk.step(chain, flags, ztab, a)
        got = gk.resident(x, flags, ztab, a, nsteps)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), chain.view(torch.int16))
