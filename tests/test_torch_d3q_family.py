"""The rest of the z-slab family in the port (``d3q27_BGK``,
``d3q27_BGK_galcor``, ``d3q19``, ``d3q19_les``) against the JAX package:
the registry, the eager step against the XLA step at f64 and at f32 on a
state that paints every node type each model reads (two zones and
gravity), the analytic 3D Poiseuille profile, and states carried across
through ``convert``.  The plain versions of the z-slab kernels are held
against ``pallas_d3q`` in ``tests/test_torch_kernels_d3q27.py``, the CUDA
kernels against those plain versions on the card in
``tests/test_torch_cuda.py``."""

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
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501
from torch_cases import (D3Q_FAMILY, d3q_family_settings,  # noqa: E402
                         paint_rich_d3q, rich_flags_d3q)

GOLDEN = dict(rtol=1e-10, atol=1e-12)      # tests/test_golden.py:30
FIELDS_TOL = dict(rtol=2e-5, atol=2e-6)    # tests/test_fastpath.py:69-76
PRECISIONS = {"f64": (jnp.float64, torch.float64, GOLDEN),
              "f32": (jnp.float32, torch.float32, FIELDS_TOL)}
SHAPE = (8, 8, 32)
# each model at the settings tests/test_pallas3d.py:84-90 runs it with
CASES = [("d3q27_BGK", {}), ("d3q27_BGK_galcor", {}),
         ("d3q19", {"S_high": 1.0}), ("d3q19", {"S_high": 1.3}),
         ("d3q19_les", {"Smag": 0.17})]


def lattice_pair(name, seed, prec="f64", **extra):
    """The same rich state of model ``name`` in both packages."""
    jdt, tdt, _ = PRECISIONS[prec]
    jm, tm = jax_model(name), get_model(name)
    a = JaxLattice(jm, SHAPE, dtype=jdt,
                   settings=d3q_family_settings(jm, **extra))
    b = Lattice(tm, SHAPE, dtype=tdt,
                settings=d3q_family_settings(tm, **extra), device="cpu")
    return paint_rich_d3q(a, seed), paint_rich_d3q(b, seed)


@pytest.mark.parametrize("name", D3Q_FAMILY)
def test_registry_matches(name):
    """Storage, settings, globals, node-type packing and quantities are
    the reference's, so flags and states cross without translation."""
    j, t = jax_model(name), get_model(name)
    q = 19 if name.startswith("d3q19") else 27
    assert t.storage_names == j.storage_names and t.n_storage == q
    np.testing.assert_array_equal(t.ei, j.ei)
    assert [(s.name, s.zonal, s.default) for s in t.settings] == \
        [(s.name, s.zonal, s.default) for s in j.settings]
    assert {n: (x.group, x.value, x.mask) for n, x in t.node_types.items()} \
        == {n: (x.group, x.value, x.mask) for n, x in j.node_types.items()}
    assert t.group_masks == j.group_masks
    assert [(g.name, g.op) for g in t.globals_] == \
        [(g.name, g.op) for g in j.globals_]
    assert [q.name for q in t.quantities] == [q.name for q in j.quantities]
    assert t.structural_key() == j.structural_key()
    assert t.fingerprint == j.fingerprint


def test_rich_flags_paint_every_type():
    """The test flags reach every boundary case each model declares, both
    collision types, the unhandled WPressureL and the objectives."""
    from tclb_tpu_torch.ops.d3q27_kernels import CASES as KERNEL_CASES
    for name in D3Q_FAMILY:
        m = get_model(name)
        flags = rich_flags_d3q(m, *SHAPE).astype(np.int64)
        for t in KERNEL_CASES[name] + ("MRT", "BGK", "WPressureL", "Inlet",
                                       "Outlet"):
            nt = m.node_types[t]
            assert ((flags & nt.mask) == nt.value).any(), (name, t)
        zones = flags >> m.zone_shift
        assert set(np.unique(zones)) == {0, 1, 2}


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name,extra", CASES)
def test_eager_matches_xla(name, extra, prec, monkeypatch):
    """12 steps on the rich state: fields, globals and every quantity, at
    the golden tolerance in f64 and the engines' f32 tolerance."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    tol = PRECISIONS[prec][2]
    a, b = lattice_pair(name, 1, prec, **extra)
    np.testing.assert_array_equal(b.state.fields.numpy(),
                                  np.asarray(a.state.fields))
    a.iterate(12)
    b.iterate(12)
    assert b.engine_name == "eager"
    assert b.state.iteration == int(a.state.iteration) == 12
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), **tol)
    ga, gb = a.get_globals(), b.get_globals()
    assert list(ga) == list(gb) and all(abs(v) > 0 for v in gb.values())
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-4 if prec == "f32"
                                   else GOLDEN["rtol"], atol=GOLDEN["atol"],
                                   err_msg=k)
    for q in a.model.quantities:
        np.testing.assert_allclose(b.get_quantity(q.name).numpy(),
                                   np.asarray(a.get_quantity(q.name)),
                                   **tol, err_msg=q.name)


def _poiseuille_flags(m, shape):
    """tests/test_models.py's channel: walls on the first axis' extremes,
    BGK collision elsewhere."""
    flags = np.full(shape, m.flag_for("BGK"), dtype=np.uint16)
    flags[0] = flags[-1] = m.flag_for("Wall")
    return flags


@pytest.mark.parametrize("name", ["d3q27_BGK", "d3q27_BGK_galcor",
                                  "d3q19_les"])
def test_poiseuille_profile(name):
    """tests/test_models.py:32-48 and :90-95 on the port's eager engine:
    the body-force-driven 14x3x4 channel's mean ux profile after 2000
    steps within 3% of ``g / (2 nu) (y - 0.5)(h + 0.5 - y)``."""
    shape, g, nu = (14, 3, 4), 1e-5, 0.1
    m = get_model(name)
    lat = Lattice(m, shape, dtype=torch.float64, device="cpu",
                  settings={"nu": nu, "GravitationX": g})
    lat.set_flags(_poiseuille_flags(m, shape))
    lat.init()
    lat.iterate(2000)
    prof = lat.get_quantity("U")[0].numpy().reshape(shape[0], -1).mean(1)
    h = shape[0] - 2
    y = np.arange(1, shape[0] - 1, dtype=np.float64)
    ana = g / (2 * nu) * (y - 0.5) * (h + 0.5 - y)
    np.testing.assert_allclose(prof[1:-1], ana, rtol=0.03)


@pytest.mark.parametrize("name", D3Q_FAMILY)
def test_state_crosses_through_convert(name, monkeypatch):
    """The JAX package's state, handed over as numpy arrays, becomes the
    port's and comes back bit for bit at f64; one step from it matches
    the XLA step."""
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    a, _ = lattice_pair(name, 2)
    a.iterate(3)
    s, p = a.state, a.params
    arrays = dict(fields=np.asarray(s.fields), flags=np.asarray(s.flags),
                  globals_=np.asarray(s.globals_),
                  iteration=np.asarray(s.iteration),
                  settings=np.asarray(p.settings),
                  zone_table=np.asarray(p.zone_table))
    state, params = state_from_numpy(get_model(name), **arrays,
                                     device="cpu")
    back = state_to_numpy(state, params)
    for key, want in arrays.items():
        np.testing.assert_array_equal(back[key], want, err_msg=key)
        assert back[key].dtype == want.dtype, key
    b = Lattice(get_model(name), SHAPE, dtype=torch.float64, device="cpu")
    b.set_state(state, params)
    a.iterate(1)
    b.iterate(1)
    assert b.state.iteration == 4
    np.testing.assert_allclose(b.state.fields.numpy(),
                               np.asarray(a.state.fields), **GOLDEN)
