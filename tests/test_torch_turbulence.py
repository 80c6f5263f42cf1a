"""Synthetic inflow turbulence in the port (``utils/turbulence.py``, the
``<SyntheticTurbulence>`` handler and ``Solver.update_synthetic_turbulence``)
against the JAX package: the same seed draws the same modes and renders the
same field, the handler reads the same wave numbers in each of its forms,
and ``example/3dcum_turbulence.xml``, shrunk, runs through both packages'
``_run_root`` at f64 to the same fields and Log columns."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import pathlib  # noqa: E402
import xml.etree.ElementTree as ET  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.control import solver as jax_solver  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu.utils import turbulence as jax_turbulence  # noqa: E402
from tclb_tpu_torch.control import solver  # noqa: E402
from tclb_tpu_torch.models import get_model  # noqa: E402
from tclb_tpu_torch.utils import turbulence  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-10, 1e-12     # tests/test_golden.py's csvdiff model
EXACT = dict(rtol=1e-12, atol=1e-12)
SYNTH = ("SynthTX", "SynthTY", "SynthTZ")


def _pair(seed):
    return turbulence.SyntheticTurbulence(seed), \
        jax_turbulence.SyntheticTurbulence(seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_von_karman_modes_and_field_match(seed):
    """The same seed: the same wavenumbers, amplitudes, energy fraction,
    mode draws (two in a row) and rendered field."""
    port, ref = _pair(seed)
    frac = [st.set_von_karman(0.4, 1.2, 0.2, 2 * np.pi / 4, 16)
            for st in (port, ref)]
    np.testing.assert_allclose(frac[0], frac[1], **EXACT)
    assert 0 < frac[0] < 1
    np.testing.assert_allclose(port.wavenumbers, ref.wavenumbers, **EXACT)
    np.testing.assert_allclose(port.amplitudes, ref.amplitudes, **EXACT)
    for _ in range(2):
        mp, mr = port.generate(), ref.generate()
        np.testing.assert_allclose(mp, mr, **EXACT)
    # the amplitude vectors stay orthogonal to the unit wavevectors
    np.testing.assert_allclose((mp[:, :3] * mp[:, 3:6]).sum(1), 0.0,
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(mp[:, :3], axis=1), 1.0)
    shape = (6, 5, 9)
    fp, fr = port.evaluate(shape), ref.evaluate(shape)
    assert fp.shape == (3,) + shape
    np.testing.assert_allclose(fp, fr, **EXACT)
    assert np.abs(fp).max() > 0


def test_one_wave_and_time_scale_match():
    port, ref = _pair(3)
    for st in (port, ref):
        st.set_one_wave(0.5)
        st.set_time_scale(8.0)
    assert port.nmodes == ref.nmodes == 1
    for steps in (1, 10, 40):
        np.testing.assert_allclose(port.ar1_factor(steps),
                                   ref.ar1_factor(steps), **EXACT)
    np.testing.assert_allclose(port.evaluate((4, 7)), ref.evaluate((4, 7)),
                               **EXACT)
    st = turbulence.SyntheticTurbulence()
    assert st.ar1_factor(5) == 0.0          # no time scale set: no memory


def _shrunk_case(**attrs):
    """example/3dcum_turbulence.xml at nx 32, ny = nz 8, Solve 40 and Log
    10; ``attrs`` replaces the <SyntheticTurbulence> attributes."""
    root = ET.parse(ROOT / "example" / "3dcum_turbulence.xml").getroot()
    geom = root.find("Geometry")
    geom.set("nx", "32")
    geom.set("ny", "8")
    geom.set("nz", "8")
    root.find("Solve").set("Iterations", "40")
    root.find("Log").set("Iterations", "10")
    if attrs:
        st = root.find("SyntheticTurbulence")
        st.attrib.clear()
        st.attrib.update(attrs)
    return root


def _run_both(root, tmp_path):
    runs = {}
    for tag, run_root, get, dtype in (
            ("port", solver._run_root, get_model, torch.float64),
            ("ref", jax_solver._run_root, jax_model, jnp.float64)):
        out = tmp_path / tag
        root.set("output", str(out) + "/")    # the XML's own wins
        kw = {"device": "cpu"} if tag == "port" else {}
        runs[tag] = (run_root(root, get(root.get("model")), None, dtype,
                              str(out) + "/", "case", **kw), out)
    return runs


def _read_log(path):
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def test_3dcum_turbulence_through_both_control_planes(tmp_path):
    """The shrunk case through both packages' _run_root at f64: the fields
    (SynthT planes included) and every Log column at RTOL 1e-10 / ATOL
    1e-12; the SynthT planes are nonzero and the inlet's ux fluctuates."""
    runs = _run_both(_shrunk_case(), tmp_path)
    (port, pout), (ref, rout) = runs["port"], runs["ref"]
    assert port.iter == ref.iter == 40
    assert port.lattice.engine_name == "eager"
    fp = port.lattice.state.fields.numpy()
    np.testing.assert_allclose(fp, np.asarray(ref.lattice.state.fields),
                               rtol=RTOL, atol=ATOL)
    hp, lp = _read_log(pout / "case_Log.csv")
    hr, lr = _read_log(rout / "case_Log.csv")
    assert hp == hr and lp.shape == lr.shape == (4, len(hp))
    keep = [i for i, h in enumerate(hp) if h != "Walltime"]
    np.testing.assert_allclose(lp[:, keep], lr[:, keep], rtol=RTOL,
                               atol=ATOL)
    m = port.model
    synth = fp[[m.storage_index[n] for n in SYNTH]]
    assert np.abs(synth).max() > 0.1
    # the inlet column (x = 0, inside the channel walls): ux = U + I S_x
    ux = port.lattice.get_quantity("U")[0].numpy()[1:-1, 1:-1, 0]
    assert ux.std() > 1e-4 and abs(ux.mean() - 0.05) < 0.01


def test_synthetic_turbulence_updates_per_segment(tmp_path):
    """The <Solve> loop draws new SynthT planes before each iterate call:
    the four Log segments leave four different SynthT states, each the
    AR(1) blend of the last one and a fresh field."""
    root = _shrunk_case()
    root.set("output", str(tmp_path) + "/")
    s = solver._run_root(root, get_model("d3q27_cumulant"), None,
                         torch.float64, str(tmp_path) + "/", "case",
                         device="cpu")
    seen = []
    lat = s.lattice
    for _ in range(3):
        s.update_synthetic_turbulence(10)
        seen.append(np.stack([lat.get_density(n).numpy() for n in SYNTH]))
    for a, b in zip(seen, seen[1:]):
        assert np.abs(a - b).max() > 1e-3
    k_aa = s.synthetic_turbulence.ar1_factor(10)
    assert k_aa == pytest.approx(np.exp(-10 / 8.0))


@pytest.mark.parametrize("attrs", [
    # the XML's own wave numbers, as lengths and as frequencies
    {"Modes": "16", "MainWaveLength": str(1 / 0.4),
     "DiffusionWaveLength": str(1 / 1.2), "TimeWaveLength": str(1 / 8)},
    {"Modes": "16", "MainWaveFrequency": str(0.4 / (2 * np.pi)),
     "DiffusionWaveFrequency": str(1.2 / (2 * np.pi)),
     "TimeWaveNumber": "8", "ShortestWaveNumber": "1.2",
     "LongestWaveNumber": "0.1"},
    {"Spectrum": "One Wave", "WaveNumber": "0.7", "TimeWaveNumber": "5"},
])
def test_wave_number_forms_match_the_reference(attrs, tmp_path):
    """Each form of the handler's wave parameters gives the reference's
    generator and run."""
    runs = _run_both(_shrunk_case(**attrs), tmp_path)
    (port, _), (ref, _) = runs["port"], runs["ref"]
    sp, sr = port.synthetic_turbulence, ref.synthetic_turbulence
    np.testing.assert_allclose(sp.wavenumbers, sr.wavenumbers, **EXACT)
    np.testing.assert_allclose(sp.amplitudes, sr.amplitudes, **EXACT)
    assert sp.time_wn == pytest.approx(sr.time_wn, rel=1e-12)
    np.testing.assert_allclose(port.lattice.state.fields.numpy(),
                               np.asarray(ref.lattice.state.fields),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attrs,match", [
    ({"Spectrum": "Kolmogorov", "TimeWaveNumber": "8"}, "unknown spectrum"),
    ({"MainWaveNumber": "0.4", "TimeWaveNumber": "8"}, "Von Karman"),
    ({"Spectrum": "One Wave", "TimeWaveNumber": "8"}, "WaveNumber"),
    ({"MainWaveNumber": "0.4", "DiffusionWaveNumber": "1.2"},
     "TimeWaveNumber"),
])
def test_bad_spectrum_raises(attrs, match, tmp_path):
    root = _shrunk_case(**attrs)
    root.set("output", str(tmp_path) + "/")
    with pytest.raises(ValueError, match=match):
        solver._run_root(root, get_model("d3q27_cumulant"), None,
                         torch.float64, str(tmp_path) + "/", "case",
                         device="cpu")
