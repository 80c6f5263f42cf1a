"""State carried across the packages: a ``.npz`` the JAX package saved is
loaded by the port and both continue in step; ``state_from_numpy`` /
``state_to_numpy`` round-trip; a port save loads into the JAX package."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402,E501

SHAPE = (24, 48)
SETTINGS = {"nu": 0.04, "Velocity": 0.02}
TOL = dict(rtol=1e-10, atol=1e-12)


def _flags(m):
    ny, nx = SHAPE
    flags = np.full(SHAPE, m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT", zone=1)
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = m.flag_for("Wall")
    flags[-1, :] = m.flag_for("Wall")
    flags[8:14, 10:14] = m.flag_for("Wall")
    flags[1:-1, 2] = m.flag_for("MRT", "Inlet")
    flags[1:-1, -3] = m.flag_for("MRT", "Outlet")
    return flags


@pytest.fixture
def jax_lattice(monkeypatch):
    monkeypatch.setenv("TCLB_FASTPATH", "0")
    m = jax_model("d2q9")
    lat = JaxLattice(m, SHAPE, dtype=jnp.float64, settings=SETTINGS)
    lat.set_flags(_flags(m))
    lat.set_setting("Velocity", 0.03, zone=1)
    lat.init()
    lat.iterate(10)
    return lat


def test_load_jax_save_and_continue(jax_lattice, tmp_path):
    path = str(tmp_path / "state")
    jax_lattice.save(path)
    port = Lattice(get_model("d2q9"), SHAPE, dtype=torch.float64,
                   device="cpu")
    port.load(path)
    assert port.state.iteration == 10
    np.testing.assert_array_equal(port.flags_numpy(),
                                  np.asarray(jax_lattice.state.flags))
    np.testing.assert_array_equal(port.state.fields.numpy(),
                                  np.asarray(jax_lattice.state.fields))
    np.testing.assert_array_equal(port.params.zone_table.numpy(),
                                  np.asarray(jax_lattice.params.zone_table))
    jax_lattice.iterate(11)
    port.iterate(11)
    assert port.state.iteration == int(jax_lattice.state.iteration) == 21
    np.testing.assert_allclose(port.state.fields.numpy(),
                               np.asarray(jax_lattice.state.fields), **TOL)
    gj, gp = jax_lattice.get_globals(), port.get_globals()
    for k in gj:
        np.testing.assert_allclose(gp[k], gj[k], **TOL, err_msg=k)


def test_port_save_loads_into_jax(jax_lattice, tmp_path):
    port = Lattice(get_model("d2q9"), SHAPE, dtype=torch.float64,
                   device="cpu")
    port.set_state(*state_from_numpy(
        port.model, np.asarray(jax_lattice.state.fields),
        np.asarray(jax_lattice.state.flags),
        np.asarray(jax_lattice.state.globals_),
        np.asarray(jax_lattice.state.iteration),
        np.asarray(jax_lattice.params.settings),
        np.asarray(jax_lattice.params.zone_table), device="cpu"))
    port.save(str(tmp_path / "p"))
    back = JaxLattice(jax_model("d2q9"), SHAPE, dtype=jnp.float64)
    back.load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(np.asarray(back.state.fields),
                                  np.asarray(jax_lattice.state.fields))
    np.testing.assert_array_equal(np.asarray(back.state.flags),
                                  np.asarray(jax_lattice.state.flags))
    assert int(back.state.iteration) == 10
    np.testing.assert_array_equal(np.asarray(back.params.settings),
                                  np.asarray(jax_lattice.params.settings))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_state_from_numpy_roundtrip(dtype):
    m = get_model("d2q9")
    rng = np.random.default_rng(11)
    fields = rng.random((m.n_storage,) + SHAPE).astype(dtype)
    flags = _flags(m)
    glob = rng.random(m.n_globals)
    settings = m.settings_vector(SETTINGS)
    table = np.repeat(settings[:, None], m.zone_max, axis=1)
    state, params = state_from_numpy(m, fields, flags, glob, np.int32(7),
                                     settings, table, device="cpu")
    assert state.fields.dtype == (torch.float32 if dtype == np.float32
                                  else torch.float64)
    assert state.flags.dtype == torch.int32 and state.iteration == 7
    back = state_to_numpy(state, params)
    np.testing.assert_array_equal(back["fields"], fields)
    np.testing.assert_array_equal(back["flags"], flags)
    assert back["flags"].dtype == np.uint16
    np.testing.assert_allclose(back["globals_"], glob.astype(dtype))
    np.testing.assert_allclose(back["settings"], settings.astype(dtype))
    assert int(back["iteration"]) == 7
    with pytest.raises(ValueError, match="do not fit"):
        state_from_numpy(m, fields[:5], flags, glob, 0, settings, table,
                         device="cpu")
    # a converted state drives a Lattice like its own
    lat = Lattice(m, SHAPE, dtype=state.fields.dtype, device="cpu")
    lat.set_state(state, params)
    lat.iterate(2)
    assert lat.state.iteration == 9
    assert dataclasses.is_dataclass(lat.state)
