"""The bf16 pass form of ``csrc/generic2d.cu`` (``NodeStorage``: a node's
pulls from its three rows and columns, wrapped once by a compare) and the
2D globals flavours' reduction (``reduce_globals`` in
``csrc/generic_common.cuh``), emulated on the CPU with numpy.

The bf16 pass form wraps a node's rows y - 1, y, y + 1 and columns x - 1,
x, x + 1 by a compare each (no integer modulo a pull) and reads plane k
from row 1 - ey_k and column 1 - ex_k of those.  The emulation does the
same for every node and must pull, for every pass-form header's velocity
table, the element the plain pull reads, on lattices down to one node
wide or high, where a neighbour wraps onto the node itself.

The globals flavours reduce each block's sums once (shuffles, then a
thread a global over the warps), and the last block to arrive adds each
global over several of its warps.  The emulation gives the same bits
whichever block arrives last and equals the same order written as plain
loops.

The kernels themselves are held bit for bit against the parent's builds
and against their plain versions on the card (``generic2d_parity``,
``tests/test_torch_cuda.py``).
"""

import re

import numpy as np
import pytest
import torch

from tclb_tpu_torch import get_model
from tclb_tpu_torch.ops import _cuda_build
from tclb_tpu_torch.ops import generic_kernels as gk

PASS_MODELS = tuple(m for m, dm in gk.DEVICE_MODELS.items()
                    if dm.ndim == 2 and gk.step_form(get_model(m)) == "pass")
SHAPES = ((37, 53), (8, 3), (5, 64), (64, 1024), (3, 1), (1, 5), (2, 2))


def _source(name: str) -> str:
    return (_cuda_build.CSRC / name).read_text()


def test_pass_form_headers():
    """The pass form's headers: the one-stage plans under 20 planes, none
    of which reads a Field (the bf16 pass form serves pulls only: its
    node storage has no Field read, and Node::load refuses it at
    compile time)."""
    assert set(PASS_MODELS) == {
        "d2q9", "d2q9_adj", "d2q9_plate", "sw", "d2q9_optimalMixing",
        "d2q9_heat", "d2q9_heat_conjugate", "d2q9_hb", "d2q9_heat_adj"}
    for name in PASS_MODELS:
        text = _source(gk.DEVICE_MODELS[name].header)
        if name.startswith("d2q9_heat") and name != "d2q9_heat_adj":
            text += _source("models/d2q9_heat_physics.cuh")
        assert "c.load(" not in text, name
    cu = _source("generic2d.cu")
    assert "constexpr bool kFieldReads<NodeStorage> = false;" in cu
    assert "static_assert(kFieldReads<Storage>," in cu


def node_pull(ex, ey, shape):
    """Emulate ``NodeStorage``: each node's rows and columns about it,
    wrapped by one compare each, and plane k read at row 1 - ey_k,
    column 1 - ex_k of them (element offsets into the stack)."""
    ny, nx = shape
    n = ny * nx
    y, x = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    row = np.stack([np.where(y > 0, y - 1, ny - 1), y,
                    np.where(y + 1 < ny, y + 1, 0)]) * nx
    col = np.stack([np.where(x > 0, x - 1, nx - 1), x,
                    np.where(x + 1 < nx, x + 1, 0)])
    return np.stack([k * n + row[1 - ey[k]] + col[1 - ex[k]]
                     for k in range(len(ex))])


def plain_pull(ex, ey, shape):
    """The element each node of each plane pulls: (y - ey, x - ex),
    periodic."""
    ny, nx = shape
    ids = np.arange(len(ex) * ny * nx).reshape(len(ex), ny, nx)
    return np.stack([np.roll(ids[k], (ey[k], ex[k]), axis=(0, 1))
                     for k in range(len(ex))])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", PASS_MODELS)
def test_node_pull_matches_the_plain_pull(name, shape):
    """Every node of every plane pulls what the plain pull reads, on the
    painted 37x53 (odd width), 8x3, 5x64, 64x1024 and lattices one or two
    nodes wide or high (x - 1 and x + 1 wrap onto the node or each
    other)."""
    ei = get_model(name).ei
    ex, ey = ei[:, 0], ei[:, 1]
    assert set(ex) <= {-1, 0, 1} and set(ey) <= {-1, 0, 1}
    np.testing.assert_array_equal(node_pull(ex, ey, shape),
                                  plain_pull(ex, ey, shape))


# --------------------------------------------------------------------------- #
# the globals reduction
# --------------------------------------------------------------------------- #


def _warp_tree(v):
    """``v += __shfl_down_sync(full, v, off)`` for off = 16 .. 1 over a
    warp's 32 values (lane l past the warp keeps its own): lane 0's."""
    v = np.array(v, dtype=np.float64)
    off = 16
    while off:
        v = v + np.concatenate([v[off:], v[-off:]])
        off //= 2
    return v[0]


def reduce_globals(acc, order, run=gk.REDUCE_RUN):
    """Emulate ``reduce_globals``: ``acc[b][t][g]`` is thread t's sum g in
    block b; the blocks arrive in ``order`` and the last adds the partials,
    its warps as the kernel maps them (global g over ``wg`` warps; warp w
    takes g = w // wg, + warps // wg, ...).  Returns the totals."""
    nb, nthreads, n = acc.shape
    warps = nthreads // 32
    wg = warps // n if n <= warps else 1
    partials = np.zeros((nb, n))
    for b in order:
        warp_sum = np.array([[_warp_tree(acc[b, 32 * w:32 * w + 32, g])
                              for w in range(warps)] for g in range(n)])
        for g in range(n):                      # thread g, over the warps
            v = 0.0
            for w in range(warps):
                v += warp_sum[g, w]
            partials[b, g] = v
    last = np.zeros((n, wg))
    for w in range(warps):
        s = w % wg
        for g in range(w // wg, n, warps // wg):
            lanes = np.zeros(32)
            for lane in range(32):
                v = 0.0
                for b0 in range(s * 32 + lane, nb, wg * 32 * run):
                    p = [partials[b0 + wg * 32 * j, g] for j in range(run)
                         if b0 + wg * 32 * j < nb]
                    for x in p:
                        v += x
                lanes[lane] = v
            last[g, s] = _warp_tree(lanes)
    out = np.zeros(n)
    for g in range(n):                          # thread g, over its warps
        v = 0.0
        for s in range(wg):
            v += last[g, s]
        out[g] = v
    return out


def fixed_order_sum(acc):
    """The same order, written as one loop a level: each block's warps by
    a shuffle tree and in order; then, for each of a global's ``wg``
    warps, each lane's blocks (32 s + l, + 32 wg, ...) in order, the
    lanes by a shuffle tree, and the warps in order."""
    nb, nthreads, n = acc.shape
    warps = nthreads // 32
    wg = warps // n if n <= warps else 1
    out = []
    for g in range(n):
        part = []
        for b in range(nb):
            v = 0.0
            for w in range(warps):
                v += _warp_tree(acc[b, 32 * w:32 * w + 32, g])
            part.append(v)
        v = 0.0
        for s in range(wg):
            v += _warp_tree([sum(part[32 * s + lane::32 * wg], 0.0)
                             for lane in range(32)])
        out.append(v)
    return np.array(out)


@pytest.mark.parametrize("nb,nthreads,n", [(7, 64, 3), (300, 32, 7),
                                           (45, 256, 1), (529, 32, 2),
                                           (700, 512, 7), (90, 256, 20)])
def test_reduction_is_the_same_for_any_arrival(nb, nthreads, n):
    """Whichever block arrives last, the totals have the same bits, equal
    the fixed order written as plain loops, and agree with an exact sum to
    double rounding."""
    import math
    rng = np.random.default_rng(nb)
    acc = rng.standard_normal((nb, nthreads, n)) * 10.0 ** rng.integers(
        -3, 4, (nb, nthreads, n))
    want = fixed_order_sum(acc)
    for seed in range(3):
        order = np.random.default_rng(seed).permutation(nb)
        got = reduce_globals(acc, order)
        assert got.tobytes() == want.tobytes()
    for g in range(n):
        exact = math.fsum(acc[:, :, g].ravel())
        assert abs(want[g] - exact) <= 1e-12 * np.abs(acc[:, :, g]).sum()


def test_pass_and_reduction_constants_match_the_source():
    """The pass form's globals kernel's blocks an SM and the reduction's
    run of loads are the source's; the pass form's globals flavours, and
    only they, take the persistent grid; every form's globals flavour
    ends in reduce_globals, none in finish_sums (K6 and the reverse
    kernels keep it)."""
    cu = _source("generic2d.cu")
    common = _source("generic_common.cuh")
    assert (f"constexpr int PASS_GLOBALS_BLOCKS = "
            f"{gk.PASS_GLOBALS_BLOCKS}, PERSISTENT_MAX_BYTES = "
            f"{gk.PERSISTENT_MAX_BYTES};") in cu
    assert ("  return PASS_FORM\n         && 2 * sizeof(S) * "
            "model::N_STORAGE < PERSISTENT_MAX_BYTES;") in cu
    assert "__launch_bounds__(BX * BY, PASS_GLOBALS_BLOCKS)" in cu
    assert ("  else if constexpr (kGlobals && persistent_globals<S>())\n"
            "    return generic2d_pass_globals_kernel<S, kSeries>;") in cu
    assert "if constexpr (!kGlobals || !persistent_globals<S>()) {" in cu
    run = int(re.search(r"WARPS = NTHREADS / 32, RUN = (\d+);",
                        common).group(1))
    assert run == gk.REDUCE_RUN
    # the ring, pass (and narrow), tiled and staged kernels
    assert cu.count("reduce_step_globals<") == 4
    assert "finish_sums<" not in cu.split('#include "generic2d_adjoint')[0]
    assert "finish_sums<" in _source("generic3d.cu")


@pytest.mark.parametrize("name", [m for m, dm in gk.DEVICE_MODELS.items()
                                  if dm.ndim == 2])
def test_persistent_globals_rule(name):
    """The persistent grid takes the pass form's globals flavours in bf16
    and, in f32, those of the headers under 16 planes: not the heat
    family's 18 and 19 (nor any other form)."""
    m = get_model(name)
    heavy = {"d2q9_heat", "d2q9_heat_conjugate", "d2q9_hb",
             "d2q9_heat_adj"}
    assert gk.persistent_globals(m, 2) == (name in PASS_MODELS)
    assert gk.persistent_globals(m, 4) == (name in PASS_MODELS
                                           and name not in heavy)


class _BlocksLib:
    """A library that reports ``blocks`` for every globals flavour and
    records its step calls and block queries."""

    def __init__(self, blocks: int):
        self.blocks, self.asked, self.calls = blocks, [], []

    def generic2d_step_blocks(self, ny, nx, bf16, series, device, out):
        self.asked.append((ny, nx, bf16, series, device))
        out._obj.value = self.blocks
        return 0

    def _step(self, *args):
        self.calls.append(args)
        return 0

    generic2d_step = generic2d_step_bf16 = generic2d_step_series = _step


@pytest.mark.parametrize("bf16,series", [(False, False), (True, False),
                                         (False, True)])
def test_globals_partials_follow_the_library(monkeypatch, bf16, series):
    """The globals flavours' partials hold a row for each block the
    library reports (its persistent grid), not a row a step tile; the
    library is asked once per shape and flavour."""
    m = get_model("d2q9_adj")
    fake = _BlocksLib(37)
    monkeypatch.setitem(gk._LIB, m.name, {"lib": fake, "tile": (16, 32)})
    monkeypatch.setattr(gk, "lib", lambda model: fake)
    monkeypatch.setattr(gk, "validate", lambda *args: None)
    monkeypatch.setattr(gk, "device_and_stream", lambda t: (0, 7))
    real_empty, made = torch.empty, []

    def empty(*args, **kw):
        made.append((args, kw.get("dtype")))
        return real_empty(*args, dtype=kw.get("dtype"))
    monkeypatch.setattr(torch, "empty", empty)
    shape = (40, 203)
    dtype = torch.bfloat16 if bf16 else torch.float32
    f = real_empty((m.n_storage,) + shape, dtype=dtype)
    flags = real_empty(shape, dtype=torch.int32)
    a = gk.step_args(m, shape, np.zeros(len(m.settings)))
    ztab = real_empty((len(m.zonal_settings), a.zone_max))
    ser = None
    if series:
        ser = gk.SeriesInputs(row=real_empty((len(m.zonal_settings),
                                              a.zone_max), dtype=torch.int32),
                              ts=real_empty((1, 4)))
        monkeypatch.setattr(gk, "series_args", lambda *args: (1, 2, 4, 0))
    for _ in range(2):
        gk._launch_step(f, flags, ztab, a, True, ser)
    assert fake.asked == [(40, 203, int(bf16), int(series), 0)]
    rows = [args for args, dt in made if dt == torch.float64]
    assert rows == [((37, len(m.globals_)),)] * 2
    assert len(fake.calls) == 2
