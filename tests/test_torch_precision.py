"""The storage ladder's error contract in the port: ``tclb_tpu_torch.
precision`` (a port of ``tclb_tpu/precision.py``) on the CPU, where both
runs of each case take the eager engine, which narrows once a step (the
JAX package measured its bounds the same way, on its XLA engine).  The
bounds are the JAX package's, copied as they are; the same harness runs
on the kernels on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import json  # noqa: E402

import pytest  # noqa: E402

from tclb_tpu import precision as jax_precision  # noqa: E402
from tclb_tpu_torch import precision  # noqa: E402


@pytest.mark.parametrize("case", precision.CASE_NAMES)
def test_bf16_error_within_documented_bounds(case):
    """tests/test_precision.py's contract at its size (64x64, 500 steps,
    checkpoints 100/250/500), f32 compute, both representations off one
    f32 run: within ERROR_BOUNDS at every checkpoint, something measured,
    and on the low-Mach cavity the shifted rung's velocity error at least
    10x below raw's."""
    raw, shifted = precision.compare_reprs(case, niter=500, n=64,
                                           storage_dtype="bfloat16",
                                           device="cpu")
    for rep in (raw, shifted):
        assert [r["iteration"] for r in rep["checkpoints"]] \
            == [100, 250, 500]
        assert rep["engine"] == f"eager[bfloat16/{rep['storage_repr']}]"
        assert precision.check_bounds(rep) == []
        assert all(r["l2"] > 0 and r["u_linf"] > 0
                   for r in rep["checkpoints"])
    if case == "cavity":
        for rr, rs in zip(raw["checkpoints"], shifted["checkpoints"]):
            assert rs["u_linf"] <= rr["u_linf"] / 10, (rr, rs)
    else:
        for rr, rs in zip(raw["checkpoints"], shifted["checkpoints"]):
            assert rs["u_linf"] <= 20 * rr["u_linf"], (rr, rs)


def test_check_bounds_flags_violations():
    rep = {"case": "cavity", "storage_dtype": "bfloat16",
           "checkpoints": [{"iteration": 100, "l2": 1.0, "linf": 1.0}]}
    v = precision.check_bounds(rep)
    assert v == jax_precision.check_bounds(rep)
    assert len(v) == 2 and all("exceeds bound" in s for s in v)


def test_check_bounds_unknown_key():
    rep = {"case": "cavity", "storage_dtype": "float16", "checkpoints": []}
    v = precision.check_bounds(rep)
    assert v and "no documented error bound" in v[0]


def test_build_case_unknown_name():
    with pytest.raises(ValueError, match="unknown precision case"):
        precision.build_case("no_such_case")


def test_cli_json_smoke(capsys):
    """The CLI on the host (``--device cpu``): exit 0, parseable JSON, one
    report per representation by default."""
    rc = precision.main(["--case", "cavity", "--niter", "60", "--n", "32",
                         "--device", "cpu", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["violations"] == []
    assert [r["storage_repr"] for r in out["reports"]] == ["raw", "shifted"]
    assert [r["iteration"] for r in out["reports"][0]["checkpoints"]] \
        == [60]


def test_cli_single_repr_text(capsys):
    rc = precision.main(["--case", "kuper_drop", "--niter", "20", "--n",
                         "24", "--repr", "shifted", "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "kuper_drop (bfloat16 storage, 24x24; engines " \
           "eager[bfloat16/shifted] against eager), repr=shifted:" in text
    assert "all error bounds hold" in text


def test_cli_reports_violations(capsys):
    """A bound the run breaks: exit 1 and a VIOLATION line."""
    saved = dict(precision.ERROR_BOUNDS)
    try:
        precision.ERROR_BOUNDS[("cavity", "bfloat16", "raw")] = {
            "l2": 0.0, "linf": 0.0}
        rc = precision.main(["--case", "cavity", "--niter", "10", "--n",
                             "16", "--repr", "raw", "--device", "cpu"])
    finally:
        precision.ERROR_BOUNDS.clear()
        precision.ERROR_BOUNDS.update(saved)
    assert rc == 1
    assert "VIOLATION: cavity @ iter 10" in capsys.readouterr().out
