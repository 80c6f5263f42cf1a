"""The resident kernels' decompositions, mirrored and emulated on the CPU.

``generic2d_resident`` (csrc/generic2d.cu) runs many steps in one
cooperative launch without a grid barrier a stage: each block owns its
tiles for the launch, runs a group of one or two steps on them (the
plan's stages on the tile plus each stage's ring, the earlier stages and
a step's result in shared memory) and, before the next, waits only for
the blocks that own the nodes within the group's reach
(csrc/resident_sync.cuh).  ``d2q9_resident8`` (csrc/d2q9.cu) keeps its
grid-stride walk and grid barriers; its pulls from the buffers written
during the launch wrap by a compare.  Neither runs here (no card); these
tests hold the Python mirrors of their constants and index arithmetic to
the sources, check that the tiles own every node once and that the waits
cover every read, and run the plain steps through each decomposition
against the plain steps on the whole lattice, bit for bit in f32: the
tiles, the rings (every value beyond what a stage may read is NaN) and the
waits (the blocks in a random order that the waits allow, every read and
write checked against the steps the two buffers hold).  They also pin the
engine every resident path of chip_smoke.py takes.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from tclb_tpu_torch import Lattice, get_model
from tclb_tpu_torch.core.lattice import LatticeState, make_stage_step
from tclb_tpu_torch.ops import d2q9_kernels as dk
from tclb_tpu_torch.ops import generic2d_parity as gp
from tclb_tpu_torch.ops import generic_kernels as gk
from torch_cases import (RICH_SETTINGS, family_settings, paint_rich,
                         paint_rich_family)

CSRC = pathlib.Path(dk.__file__).resolve().parents[1] / "csrc"
SMEM_BLOCK = 227 * 1024          # the most shared memory a block takes
SMEM_SM = 228 * 1024             # an SM's, less 1 KB a block
D2Q9_MODELS = tuple(dk.MODEL_ID)
GENERIC_2D = tuple(m for m, dm in gk.DEVICE_MODELS.items() if dm.ndim == 2)
# lattices of the emulations: srt_poiseuille's 21x40, a ragged 37x53 and
# one smaller than a tile plus its ring
SHAPES = ((21, 40), (37, 53), (5, 7))


def _constants(name: str) -> dict:
    """``constexpr int NAME = <int>`` definitions of a source (each name
    its first definition), as ints."""
    text = (CSRC / name).read_text()
    out = {}
    for key, value in re.findall(r"constexpr int (\w+) = (\d+)[;,]", text):
        out.setdefault(key, int(value))
    for key, value in re.findall(r", (\w+) = (\d+);", text):
        out.setdefault(key, int(value))
    return out


# --------------------------------------------------------------------------- #
# the protocol both kernels share
# --------------------------------------------------------------------------- #


def _needed(shape, tile, reach: int, blocks: int) -> list:
    """For each block: the owners of the nodes within ``reach`` of the
    nodes of its tiles that lie inside the lattice (what its outputs need;
    the kernels also compute a ragged tile's rows and columns past the
    edge, wrapped, whose values no output reads)."""
    ny, nx = shape
    ty, tx = tile
    ntx = -(-nx // tx)
    owner = ((np.arange(ny)[:, None] // ty) * ntx
             + np.arange(nx)[None] // tx) % blocks
    out = [set() for _ in range(blocks)]
    for t in range(ntx * -(-ny // ty)):
        y0, x0 = t // ntx * ty, t % ntx * tx
        ys = np.arange(y0 - reach, min(y0 + ty, ny) + reach) % ny
        xs = np.arange(x0 - reach, min(x0 + tx, nx) + reach) % nx
        out[t % blocks].update(int(o) for o in owner[np.ix_(ys, xs)].ravel())
    return out


def emulate(fields, nsteps: int, tile, reach: int, blocks: int, tile_step,
            seed: int = 0):
    """A resident launch on the CPU: block b owns the tiles b, b + blocks,
    ... (row-major); in a random order, a block whose wait set
    (``gk.resident_waits``) has published step s runs step s on each of
    its tiles, ``tile_step(src, y0, x0)``, from the input (s = 0) or the
    buffer step s - 1 wrote into the other (scratch for even s, the output
    for odd), then publishes s + 1.  Each node of a buffer carries the
    step its value is from: what a tile's outputs need (``_needed``) must
    be of the step it wants, and a write must find every block whose
    outputs need the old value done with it."""
    ny, nx = fields.shape[1:]
    ty, tx = tile
    ntx = -(-nx // tx)
    ntiles = ntx * -(-ny // ty)
    waits = gk.resident_waits((ny, nx), tile, reach, blocks)
    needed = _needed((ny, nx), tile, reach, blocks)
    readers = [[b for b in range(blocks) if c in needed[b]]
               for c in range(blocks)]
    buf = {"out": torch.full_like(fields, float("nan")),
           "scratch": torch.full_like(fields, float("nan"))}
    version = {k: np.full((ny, nx), -1) for k in buf}
    done = [0] * blocks
    rng = np.random.default_rng(seed)
    while min(done) < nsteps:
        ready = [b for b in range(blocks) if done[b] < nsteps
                 and all(done[c] >= done[b] for c in waits[b])]
        b = int(rng.choice(ready))
        s = done[b]
        read = "scratch" if s % 2 else "out"
        src = fields if s == 0 else buf[read]
        dst = "out" if s % 2 else "scratch"
        for t in range(b, ntiles, blocks):
            y0, x0 = t // ntx * ty, t % ntx * tx
            if s > 0:
                ys = np.arange(y0 - reach, min(y0 + ty, ny) + reach) % ny
                xs = np.arange(x0 - reach, min(x0 + tx, nx) + reach) % nx
                assert (version[read][np.ix_(ys, xs)] == s).all(), \
                    "read before its writer published"
                assert all(done[r] >= s for r in readers[b]), \
                    "overwrote what a reader still needs"
            new = tile_step(src, y0, x0)
            h, w = min(ty, ny - y0), min(tx, nx - x0)
            buf[dst][:, y0:y0 + h, x0:x0 + w] = new[:, :h, :w]
            version[dst][y0:y0 + h, x0:x0 + w] = s + 1
        done[b] = s + 1
    return buf["out" if nsteps % 2 == 0 else "scratch"]


def _region(shape, y0, x0, ty, tx, ext):
    """The nodes within ``ext`` of the tile at (y0, x0), wrapped."""
    ny, nx = shape
    keep = torch.zeros(shape, dtype=torch.bool)
    ys = np.arange(y0 - ext, y0 + ty + ext) % ny
    xs = np.arange(x0 - ext, x0 + tx + ext) % nx
    keep[np.ix_(ys, xs)] = True
    return keep


def _poisoned(fields, keep, planes=None):
    """``fields`` with NaN beyond ``keep`` (on ``planes``, default all)."""
    out = fields.clone()
    sel = torch.ones(fields.shape[0], dtype=torch.bool) if planes is None \
        else planes
    out[sel[:, None, None] & ~keep] = float("nan")
    return out


# --------------------------------------------------------------------------- #
# d2q9_resident8
# --------------------------------------------------------------------------- #


def wrap_one(i, n):
    """csrc/d2q9.cu's ``wrap_one``: ``i mod n`` for i in [-1, n] by a
    compare."""
    return np.where(i < 0, i + n, np.where(i >= n, i - n, i))


def test_resident8_keeps_its_grid_and_wraps_by_compare():
    """``d2q9_resident8`` keeps its decomposition (the lattice walked
    with a grid stride, a grid barrier between two steps, a cooperative
    launch of the blocks the device holds) and its pulls from the buffers
    written during the launch wrap by ``wrap_one``; the step kernels' pulls
    keep ``wrap``."""
    text = (CSRC / "d2q9.cu").read_text()
    assert ("__device__ __forceinline__ int wrap_one(int i, int n) {\n"
            "  return i < 0 ? i + n : (i >= n ? i - n : i);\n}") in text
    assert ("    const int row = kCoherent ? wrap_one(yk, a.ny) : "
            "wrap(yk, a.ny);") in text
    assert ("    const int col = kCoherent ? wrap_one(xk, a.nx) : "
            "wrap(xk, a.nx);") in text
    kernel = text[text.index("d2q9_resident8_kernel(const float*"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "step_node<true>(a, y, x, src, dst, fin, flags, vel, den);" \
        in kernel and "grid.sync();" in kernel
    assert "cudaLaunchCooperativeKernel" in text
    assert '#include "resident_sync.cuh"' not in text


@pytest.mark.parametrize("n", [1, 2, 3, 40, 1024])
def test_resident8_wrap_one_is_the_modulo(n):
    """``wrap_one`` takes every pull of reach 1 from a node of an n-node
    row (i - e for i in [0, n), e in {-1, 0, 1}) where ``wrap`` does."""
    i = np.arange(n)
    for e in (-1, 0, 1):
        assert (wrap_one(i - e, n) == (i - e) % n).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model", D2Q9_MODELS)
def test_resident8_emulation_matches_plain(model, shape):
    """``d2q9_resident8``'s 8 steps with each step's pulls gathered at the
    rows and columns ``wrap_one`` gives (the plain step's collision then
    run on them, its own pull undone) equal the plain 8 steps on the
    whole lattice bit for bit (f32, CPU), also where the lattice is
    smaller than a block of threads."""
    f, flags, vel, den, a = _d2q9_state(model, shape)
    ny, nx = shape
    y, x = np.arange(ny), np.arange(nx)
    g = f
    for _ in range(dk.RESIDENT_FUSE):
        pulled = torch.stack([
            g[k][wrap_one(y - a.ey[k], ny)][:, wrap_one(x - a.ex[k], nx)]
            for k in range(9)])
        pre = g.clone()
        pre[:9] = torch.stack([torch.roll(pulled[k], (-a.ey[k], -a.ex[k]),
                                          (0, 1)) for k in range(9)])
        g = dk.plain_steps(pre, flags, vel, den, a, 1)
    want = dk.plain_steps(f, flags, vel, den, a, dk.RESIDENT_FUSE)
    assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def _d2q9_state(model: str, shape):
    m = get_model(model)
    if model == "d2q9":
        lat = paint_rich(Lattice(m, shape, dtype=torch.float32, device="cpu",
                                 settings=RICH_SETTINGS), 5)
    else:
        lat = paint_rich_family(Lattice(m, shape, dtype=torch.float32,
                                        device="cpu",
                                        settings=family_settings(m)), 5)
    return dk.kernel_inputs(lat.model, lat.state, lat.params)


# --------------------------------------------------------------------------- #
# generic2d_resident
# --------------------------------------------------------------------------- #


def test_resident_tile_mirrors_the_source():
    """``gk.RESIDENT_REGION`` and ``HALO`` are csrc/generic2d.cu's, which
    reports its tile through ``generic2d_resident_tile`` and waits through
    csrc/resident_sync.cuh (acquire after relaxed spins, release stores),
    no grid barrier but the one that orders the counters' reset."""
    c = _constants("generic2d.cu")
    text = (CSRC / "generic2d.cu").read_text()
    rr = gk.RESIDENT_REGION
    assert c["KRX"] == rr["cols"] and c["HALO"] == gk.HALO
    assert (f"KRY = model::N_STAGES > 1 ? {rr['rows']} : "
            f"{rr['one_stage_rows']};") in text
    assert "const int ring0 = (fuse - 1) * reach + KE;" in text
    assert ("static void resident_plan(int reach, int* fuse, int* ty, "
            "int* tx)") in text
    assert ("      || 2 * (KRY - 2 * ring0) * (KRX - 2 * ring0) < KRY * "
            "KRX) {") in text
    assert '#include "resident_sync.cuh"' in text
    sync = (CSRC / "resident_sync.cuh").read_text()
    assert f"RESIDENT_MAX_BLOCKS = {gk.RESIDENT_MAX_BLOCKS};" in sync
    assert "ld.relaxed.gpu.global.s32" in sync
    assert "fence.acq_rel.gpu" in sync
    assert "st.release.gpu.global.s32" in sync
    code = re.sub(r"//.*", "", text)
    assert code.count("grid().sync()") == 1 and "grid.sync" not in code
    assert "generic2d_resident_capacity" not in code


@pytest.mark.parametrize("model", GENERIC_2D)
def test_resident_tile_fits(model):
    """Each 2D header's tile: a group's first stage one node a thread of
    its region, the tile inside the ring the group computes (two steps a
    group where that leaves half of the region: every one-stage header
    and the two-stage plans of ring 1, d2q9_kuper, d2q9_kuper_adj,
    d2q9_pp_LBL and d2q9_pf_curvature), rings that shrink, the earlier stages' planes and a
    step's result within a block's shared memory."""
    m = get_model(model)
    t = gk.resident_tile(m)
    (ry, rx), (ty, tx), ring0 = t["region"], t["tile"], t["ring"]
    plan, reach = gk.action_plan(m)
    assert ry * rx == t["threads"] <= 1024
    assert ring0 == (t["fuse"] - 1) * reach + plan[0][1]
    assert (ty, tx) == (ry - 2 * ring0, rx - 2 * ring0) and min(ty, tx) >= 2
    r2 = reach + plan[0][1]
    two = ry - 2 * r2 >= 2 and 2 * (ry - 2 * r2) * (rx - 2 * r2) >= ry * rx
    assert (t["fuse"] == 2) == two
    assert two == (len(plan) == 1 or model in (
        "d2q9_kuper", "d2q9_kuper_adj", "d2q9_pp_LBL", "d2q9_pf_curvature"))
    assert list(t["rings"]) == sorted(t["rings"], reverse=True)
    assert t["rings"][-1] == 0 and t["smem"] <= SMEM_BLOCK
    assert t["smem"] == 4 * m.n_storage * ry * rx * (
        (len(plan) > 1) + (t["fuse"] > 1))
    assert reach <= gk.HALO


@pytest.mark.parametrize("blocks", [None, 1, 3])
@pytest.mark.parametrize("shape", SHAPES + ((128, 128), (64, 512)))
@pytest.mark.parametrize("model", ["d2q9_heat", "d2q9_kuper", "d2q9_lee",
                                   "d2q9_npe_guo", "d2q9_pp_MCMP"])
def test_resident_waits_cover_every_read(model, shape, blocks):
    """Every node has one tile, so one owner; a block's wait set holds the
    owner of every node within the plan's reach of its tiles (wrapped),
    itself among them, and every block whose outputs need one of its
    nodes (``_needed``): a block that overwrites a buffer has waited for
    every block that still needs the value there, which is what lets two
    buffers do."""
    m = get_model(model)
    t = gk.resident_tile(m, shape)
    nb = t["blocks"] if blocks is None else min(blocks, t["blocks"])
    ny, nx = shape
    ty, tx = t["tile"]
    reach = gk.action_plan(m)[1]
    ntx = -(-nx // tx)
    owner = ((np.arange(ny)[:, None] // ty) * ntx
             + np.arange(nx)[None] // tx) % nb
    waits = gk.resident_waits(shape, t["tile"], reach, nb)
    for tile in range(t["tiles"][0] * t["tiles"][1]):
        y0, x0 = tile // ntx * ty, tile % ntx * tx
        ys = np.arange(y0 - reach, y0 + ty + reach) % ny
        xs = np.arange(x0 - reach, x0 + tx + reach) % nx
        assert set(owner[np.ix_(ys, xs)].ravel()) <= waits[tile % nb]
    needed = _needed(shape, t["tile"], reach, nb)
    for b in range(nb):
        assert b in waits[b] and needed[b] <= waits[b]
        for c in range(nb):
            if b in needed[c]:
                assert c in waits[b]


@pytest.mark.parametrize("blocks", [None, 2])
@pytest.mark.parametrize("shape", SHAPES[:2] + ((9, 20),))
@pytest.mark.parametrize("model", ["d2q9_heat", "d2q9_kuper",
                                   "d2q9_poison_boltzmann"])
def test_resident_emulation_matches_plain(model, shape, blocks):
    """A one-, a two- and a three-stage plan through the resident tiles,
    their rings and the waits (every block its own tile, or two blocks
    with many tiles each; the blocks in a random order) give the plain
    steps on the whole lattice bit for bit (f32, CPU).  A tile's group
    (``fuse`` steps: two for the one- and two-stage plans) runs the plain
    stages one by one: a step sees the group's input within its reach of
    the tile, or the step before's planes within the ring that step
    computed, and stage s the planes the stages before it wrote within
    stage s - 1's ring (NaN beyond), as the kernel's state and stack hold
    them.  (The painter needs more columns than 5x7 has; 9x20
    is smaller than each tile plus its ring.  d2q9_lee's and d2q9_pp_MCMP's
    plain first stages spread a NaN beyond their reach, so the NaN rings
    cannot show their reads; d2q9_poison_boltzmann's three stages keep
    one where it was.)"""
    m = get_model(model)
    lat = gp.paint(m, shape, device="cpu")
    f, flags, ztab, a = gk.kernel_inputs(m, lat.state, lat.params)
    t = gk.resident_tile(m, shape)
    nb = t["blocks"] if blocks is None else min(blocks, t["blocks"])
    plan, reach = gk.action_plan(m)
    ty, tx = t["tile"]
    fuse = t["fuse"]
    params = gk._plain_params(ztab, a)
    steps = [make_stage_step(m, name, compute_globals=False)
             for name, _ in plan]

    def tile_step(src, y0, x0):
        fields = _poisoned(src, _region(shape, y0, x0, ty, tx, fuse * reach))
        for j in range(fuse):
            ring = (fuse - 1 - j) * reach
            state = LatticeState(fields=fields, flags=flags,
                                 globals_=torch.zeros((m.n_globals,)),
                                 iteration=0)
            written = torch.zeros((m.n_storage,), dtype=torch.bool)
            for s, (step, (_, ext)) in enumerate(zip(steps, plan)):
                before = state.fields
                state = step(state, params)
                written |= ((state.fields != before)
                            & ~before.isnan()).flatten(1).any(dim=1)
                keep = _region(shape, y0, x0, ty, tx, ring + ext)
                state = dataclasses.replace(
                    state, fields=_poisoned(state.fields, keep, written))
            fields = state.fields
        out = fields[:, y0:y0 + ty, x0:x0 + tx]
        assert not out.isnan().any()
        return out
    nsteps = 4
    got = emulate(f, nsteps // fuse, t["tile"], fuse * reach, nb, tile_step,
                  seed=shape[0])
    want = gk.plain_steps(f, flags, ztab, a, nsteps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_resident_wrapper_hands_counters_and_reach(monkeypatch):
    """``resident`` on a CUDA tensor is one ``generic2d_resident`` call:
    a second stack, one counter a tile of the library's resident tile,
    the step count and the plan's reach; no scratch stack of the earlier
    stages, no block count."""
    m = get_model("d2q9_lee")
    calls, made = [], []

    class Fake:
        def generic2d_resident(self, *args):
            calls.append(args)
            return 0
    fake = Fake()
    monkeypatch.setitem(gk._LIB, m.name, {"lib": fake, "tile": (16, 32),
                                          "resident_tile": (8, 24)})
    monkeypatch.setattr(gk, "lib", lambda model: fake)
    monkeypatch.setattr(gk, "validate", lambda *args: None)
    monkeypatch.setattr(gk, "device_and_stream", lambda t: (0, 7))
    real_empty = torch.empty
    shape = (20, 50)
    f = real_empty((m.n_storage,) + shape)
    flags = real_empty(shape, dtype=torch.int32)
    a = gk.step_args(m, shape, np.zeros(len(m.settings)))
    ztab = real_empty((len(m.zonal_settings), a.zone_max))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))

    def empty(*args, **kw):
        made.append((args, kw.get("dtype")))
        return real_empty(*args, dtype=kw.get("dtype"))
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: real_empty(t.shape, dtype=t.dtype))
    gk.reset_launches()
    gk.resident(f, flags, ztab, a, 6)
    (args,) = calls
    assert len(args) == 11 and args[-4:] == (6, 6, 0, 7)
    assert made == [(((3 * 3,),), torch.int32)]
    assert gk.LAUNCHES["generic2d_resident"] == 1


# --------------------------------------------------------------------------- #
# engine selection on chip_smoke's resident paths
# --------------------------------------------------------------------------- #

RESIDENT_PATHS = [
    # (module, model, shape, storage dtype, tag)
    (dk, "d2q9", (100, 1024), None, "cuda_d2q9_resident[d2q9,fuse=8]"),
    *[(dk, m, s, None, f"cuda_d2q9_resident[{m},fuse=8]") for m, s in (
        ("d2q9_SRT", (21, 40)), ("d2q9_les", (96, 512)),
        ("d2q9_inc", (128, 1024)), ("d2q9_cumulant", (128, 1024)),
        ("d2q9_new", (128, 1024)))],
    *[(gk, m, s, None, f"cuda_generic_resident[{m},fuse=N]")
      for m, (s, _) in gp.RESIDENT_PATHS.items() if m != "d2q9"],
    (gk, "d2q9", (64, 64), torch.bfloat16,
     "cuda_generic_resident[d2q9,fuse=N,bfloat16/shifted]"),
    (gk, "d2q9_kuper", (64, 64), torch.bfloat16,
     "cuda_generic_resident[d2q9_kuper,fuse=N,bfloat16/shifted]"),
]


@pytest.mark.parametrize("mod,model,shape,storage,tag", RESIDENT_PATHS)
def test_select_engine_keeps_the_resident_paths(mod, model, shape, storage,
                                                tag):
    """Every (model, lattice) chip_smoke.py runs on a resident engine
    still selects it: the redesigned kernels take what the grid-barrier
    kernels took, by the same rule (the stacks within half the L2)."""
    kw = {} if storage is None else {"storage_dtype": storage,
                                     "storage_repr": "shifted"}
    fn, got = mod.select_engine(get_model(model), shape, torch.float32, **kw)
    assert got == tag and fn is not None


@pytest.mark.parametrize("shape", [(1024, 1024), (512, 1024)])
def test_select_engine_keeps_the_band_paths(shape):
    """Lattices past half the L2 keep the band engines."""
    _, tag = dk.select_engine(get_model("d2q9"), shape, torch.float32)
    assert tag == "cuda_d2q9_band[d2q9,fuse=2]"
    _, tag = gk.select_engine(get_model("d2q9_kuper"), shape, torch.float32)
    assert tag == "cuda_generic_band[d2q9_kuper,fuse=1]"
