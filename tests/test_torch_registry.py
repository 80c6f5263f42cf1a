"""The PyTorch port's registry against the JAX package's, for ``d2q9``:
storage layout, settings (order, defaults, derived values), globals,
node-type bit packing and flag composition must be identical, so states and
flags cross between the packages without translation."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch.models import get_model, list_models  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    return jax_model("d2q9"), get_model("d2q9")


def test_storage_and_groups(pair):
    j, t = pair
    assert t.storage_names == j.storage_names
    assert t.storage_index == j.storage_index
    assert t.n_storage == j.n_storage == 11
    assert t.groups == j.groups
    np.testing.assert_array_equal(t.ei, j.ei)
    assert t.ndim == j.ndim == 2
    assert t.max_stencil == j.max_stencil


def test_settings_order_defaults_and_derived(pair):
    j, t = pair
    assert [s.name for s in t.settings] == [s.name for s in j.settings]
    assert [(s.zonal, s.default) for s in t.settings] == \
        [(s.zonal, s.default) for s in j.settings]
    assert t.zonal_settings == j.zonal_settings
    np.testing.assert_array_equal(t.setting_defaults, j.setting_defaults)
    np.testing.assert_array_equal(t.settings_vector(), j.settings_vector())
    vals = {"nu": 0.02, "Velocity": 0.01, "S3": -0.25}
    np.testing.assert_array_equal(t.settings_vector(vals),
                                  j.settings_vector(vals))
    # nu -> omega -> S78 propagates in both
    vec = t.settings_vector({"nu": 0.02})
    assert vec[t.setting_index["S78"]] == pytest.approx(
        1.0 - 1.0 / (3 * 0.02 + 0.5))


def test_node_types_and_masks(pair):
    j, t = pair
    assert set(t.node_types) == set(j.node_types)
    for name, nt in j.node_types.items():
        got = t.node_types[name]
        assert (got.group, got.value, got.mask, got.shift, got.index) == \
            (nt.group, nt.value, nt.mask, nt.shift, nt.index), name
    assert t.group_masks == j.group_masks
    assert (t.zone_shift, t.zone_bits, t.zone_max) == \
        (j.zone_shift, j.zone_bits, j.zone_max)
    for names, zone in ((("MRT",), 0), (("WVelocity", "MRT"), 1),
                        (("MRT", "Inlet"), 3), (("Wall",), 0),
                        (("EPressure", "MRT", "Outlet"), 2),
                        (("TopSymmetry", "MRT"), 5)):
        assert t.flag_for(*names, zone=zone) == j.flag_for(*names, zone=zone)


def test_globals_quantities_and_actions(pair):
    j, t = pair
    assert [(g.name, g.op) for g in t.globals_] == \
        [(g.name, g.op) for g in j.globals_]
    assert t.global_index == j.global_index
    assert [(q.name, q.vector, q.adjoint) for q in t.quantities] == \
        [(q.name, q.vector, q.adjoint) for q in j.quantities]
    assert t.actions == j.actions
    assert {k: (s.main, s.load_densities) for k, s in t.stages.items()} == \
        {k: (s.main, s.load_densities) for k, s in j.stages.items()}
    assert t.structural_key() == j.structural_key()
    assert t.fingerprint == j.fingerprint


def test_catalogue_names_the_roadmap_for_models_not_ported():
    """The port's catalogue is the JAX package's: all 42 models, so no
    model is left to port; a name in neither raises KeyError."""
    from tclb_tpu.models import list_models as jax_list_models
    assert list_models() == jax_list_models()
    assert len(list_models()) == 42
    for name in ("d2q9_kuper_adj", "d3q19_heat_adj", "d3q19_heat_adj_art",
                 "d3q19_heat_adj_prop"):
        assert get_model(name).name == name
    with pytest.raises(KeyError, match="not in the catalogue"):
        get_model("d2q9_no_such_model")


@pytest.mark.parametrize("name", ["d2q9_SRT", "d2q9_les", "d2q9_inc",
                                  "d2q9_cumulant", "d2q9_new"])
def test_family_on_the_d2q9_kernels(name):
    """Each family model is the reference's own registry entry and is
    taken by the d2q9 kernels at f32 (engine tag per model), by none at
    f64."""
    from tclb_tpu_torch.ops import d2q9_kernels
    j, t = jax_model(name), get_model(name)
    assert t.structural_key() == j.structural_key()
    assert t.fingerprint == j.fingerprint
    assert d2q9_kernels.supports(t, (100, 1024), np.float32) is False
    import torch
    assert d2q9_kernels.supports(t, (100, 1024), torch.float32)
    assert d2q9_kernels.select_engine(t, (100, 1024), torch.float32)[1] \
        == f"cuda_d2q9_resident[{name},fuse=8]"
    assert d2q9_kernels.select_engine(t, (100, 1024), torch.float64) \
        == (None, None)
