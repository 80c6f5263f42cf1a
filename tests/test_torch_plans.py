"""The pure-Python planners that the two redesigned kernels rely on, on the
CPU: ``d3q27_step2``'s columns by model (read from csrc/d3q27.cu, whose
library reports them to the wrapper), its z runs and shared memory
(``ops/d3q27_kernels.py``: ``step2_planes``, ``step2_smem``) at
3d_channel's and channel48's shape, and ``generic2d_step``'s forms and the
staged tile (``ops/generic_kernels.py``: ``step_form``, ``staged_tile``),
each against the constants of the CUDA source it mirrors and, for the
staged tile, against ``action_plan``'s rings; the step's arguments (no
scratch stack ``mid``); the build digest over the headers that declare a
plan's reach. The kernels themselves are held against their plain versions
on the card by ``tests/test_torch_cuda.py``, and against the parent's
builds bit for bit by ``d3q27_build_parity.py`` and ``generic2d_parity``.
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from tclb_tpu_torch import get_model
from tclb_tpu_torch.ops import _cuda_build
from tclb_tpu_torch.ops import d3q27_kernels as dk3
from tclb_tpu_torch.ops import generic_kernels as gk

STAGED = ("d2q9_pp_MCMP", "d2q9_lee", "d2q9_poison_boltzmann")
RING = ("d2q9_kuper", "d2q9_pf_pressureEvolution")
TILED = ("d2q9_npe_guo",)
NARROW = ("d2q9_solid",)
MODELS_2D = tuple(m for m, dm in gk.DEVICE_MODELS.items() if dm.ndim == 2)
SMEM_LIMIT = 227 * 1024
# 3d_channel.xml's lattice and bench.py's 48x48x256 channel (nz, ny, nx)
CHANNEL3D = CHANNEL48 = (48, 48, 256)
SMS = 132                       # an H100's SMs


def _source(name: str) -> str:
    return (_cuda_build.CSRC / name).read_text()


# --------------------------------------------------------------------------- #
# d3q27_step2
# --------------------------------------------------------------------------- #


def _step2_rows() -> dict:
    """The rows of a d3q27_step2 column by model, as csrc/d3q27.cu sets TY
    for each D3Q_MODEL id (8 for the two ids it names, else 12)."""
    text = _source("d3q27.cu")
    ids = re.search(r"#if D3Q_MODEL == (\d) \|\| D3Q_MODEL == (\d)\n"
                    r"#define TY 8\n#define STEP2_BLOCKS_PER_SM 2\n#else\n"
                    r"#define TY 12\n#define STEP2_BLOCKS_PER_SM 1\n", text)
    eight = {dk3.MODELS[int(i)] for i in ids.groups()}
    return {m: 8 if m in eight else 12 for m in dk3.MODELS}


def test_step2_rows_match_the_source():
    """csrc/d3q27.cu gives 8 rows (two blocks an SM) to d3q27_BGK and
    d3q19_les and 12 (one) to the others, the cumulant's default build
    among them, and bounds the kernel's launch by those blocks an SM."""
    rows = _step2_rows()
    assert {m for m, r in rows.items() if r == 8} == {"d3q27_BGK",
                                                       "d3q19_les"}
    assert rows[dk3.MODEL] == 12
    assert "__launch_bounds__(STEP2_THREADS, STEP2_BLOCKS_PER_SM)" in \
        _source("d3q27.cu")


@pytest.mark.parametrize("shape", [CHANNEL3D, CHANNEL48])
@pytest.mark.parametrize("model", dk3.MODELS)
def test_step2_z_runs_at_the_channels(model, shape):
    """At 48x48x256: 32 columns of 32x12 take z runs of 12 planes, 128
    blocks on 132 SMs at one block an SM, step 1 on 14 planes of 34x14
    for 12 of 32x12 (1.45 extended nodes an output node, against 1.59 for
    32x8 columns); 48 columns of 32x8 at two blocks an SM take runs of
    10 (240 blocks of 264)."""
    rows = _step2_rows()[model]
    per_sm = 1 if rows == 12 else 2
    zc = dk3.step2_planes(shape, SMS * per_sm, rows)
    nz, ny, nx = shape
    columns = math.ceil(ny / rows) * math.ceil(nx / 32)
    blocks = columns * math.ceil(nz / zc)
    assert (zc, columns, blocks) == ((12, 32, 128) if rows == 12
                                     else (10, 48, 240))
    assert blocks <= SMS * per_sm
    recompute = (zc + 2) / zc * (34 * (rows + 2)) / (32 * rows)
    assert recompute == pytest.approx(1.4462 if rows == 12 else 1.59375,
                                      abs=1e-4)


@pytest.mark.parametrize("model", dk3.MODELS)
def test_step2_shared_memory_budget(model):
    """A block's ring of step-1 planes (ez = -1 of one plane, ez = 0 of
    two, ez = +1 of three: 54 population planes for 27 velocities, 38 for
    d3q19) over the extended column, and the cumulant's increments of two
    planes, in f32: within 227 KB, and within 113 KB (two blocks an SM,
    with a KB each reserved) where the build runs two blocks an SM."""
    rows = _step2_rows()[model]
    ring = 38 if model in ("d3q19", "d3q19_les") else 54
    sinc = 2 * 4 * 32 * rows if model == dk3.MODEL else 0
    smem = dk3.step2_smem(model, rows)
    assert smem == (ring * 34 * (rows + 2) + sinc) * 4 <= SMEM_LIMIT
    assert rows == 12 or smem <= 113 * 1024
    assert dk3.step2_smem(dk3.MODEL, 12) == 115104


# --------------------------------------------------------------------------- #
# generic2d_step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", MODELS_2D)
def test_step_form(name):
    """The staged form takes the three-stage plans, the two-stage plans
    with a ring of at most two the ring form; of the one-stage plans,
    npe_guo's 45 planes take the tiled form, solid's 29 the narrow pass,
    the others (9-19 planes) keep the one-node-a-thread pass."""
    want = ("staged" if name in STAGED else "ring" if name in RING
            else "tiled" if name in TILED else "narrow" if name in NARROW
            else "pass")
    assert gk.step_form(get_model(name)) == want
    assert (len(gk.DEVICE_MODELS[name].plan) == 1) == (
        want in ("pass", "narrow", "tiled"))


@pytest.mark.parametrize("name,tile,halo,smem", [
    ("d2q9_lee", (16, 32), 6, 96448),
    ("d2q9_pp_MCMP", (8, 32), 3, 77120),
    ("d2q9_poison_boltzmann", (16, 32), 3, 68464)])
def test_staged_tile_against_the_plan(name, tile, halo, smem):
    """The staged tile's extents are action_plan's: stage s runs on the
    output tile plus its ring, reads no further than the stage before it
    computed, and stage 0 no further than the staged input; two blocks an
    SM where 16 rows fit (MCMP's 20 planes take 8 rows)."""
    m = get_model(name)
    plan, reach = gk.action_plan(m)
    st = gk.staged_tile(m)
    assert st["tile"] == tile and st["halo"] == halo == reach
    assert st["rings"] == tuple(ext for _, ext in plan)
    ty, tx = tile
    assert st["input"] == (ty + 2 * halo, tx + 2 * halo)
    assert st["stack"] == (ty + 2 * plan[0][1], tx + 2 * plan[0][1])
    assert st["smem"] == smem == 4 * m.n_storage * (
        st["input"][0] * st["input"][1] + st["stack"][0] * st["stack"][1])
    assert smem <= gk.TWO_BLOCKS_SMEM <= SMEM_LIMIT // 2
    assert plan[-1][1] == 0
    for s in range(1, len(plan)):
        assert plan[s][1] + gk.stage_reach(m, plan[s][0]) <= plan[s - 1][1]
    assert plan[0][1] + gk.stage_reach(m, plan[0][0]) <= halo
    assert st["stage0_per_node"] == pytest.approx(
        st["stack"][0] * st["stack"][1] / (ty * tx))


@pytest.mark.parametrize("name", MODELS_2D)
def test_header_declares_the_reach_of_a_staged_plan(name):
    """A staged or tiled plan's header declares model::REACH,
    action_plan's reach (generic2d.cu stages its input with it); no other
    header does."""
    text = _source(gk.DEVICE_MODELS[name].header)
    hit = re.search(r"constexpr int REACH = (\d+);", text)
    if name in STAGED + TILED:
        assert int(hit.group(1)) == gk.action_plan(get_model(name))[1]
    else:
        assert hit is None


def test_generic2d_constants_match_the_source():
    """The planner's block shapes and budget are csrc/generic2d.cu's."""
    text = _source("generic2d.cu")
    assert "constexpr int BX = 32, BY = 16;" in text
    assert gk.BLOCK == (16, 32)
    assert "constexpr int STAGED_THREADS = 512;" in text
    assert "constexpr size_t TWO_BLOCKS_SMEM = 113 * 1024;" in text
    assert gk.TWO_BLOCKS_SMEM == 113 * 1024
    assert "STY = staged_smem(16) <= TWO_BLOCKS_SMEM ? 16 : 8;" in text


def _int_constant(text: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)[;,]", text).group(1))


def test_step_form_rule_matches_the_source():
    """generic2d.cu's compile-time rule and ``step_form`` agree: the
    source's constants are the planner's, and the rule as the source
    writes it, on each 2D header's planes and plan, names the form
    ``step_form`` names."""
    text = _source("generic2d.cu")
    consts = {n: _int_constant(text, n) for n in (
        "RTX", "RTY", "RBY", "RING_BLOCKS", "TTX", "TTY", "TILED_BLOCKS",
        "TILED_MIN_PLANES", "NARROW_MIN_PLANES")}
    assert consts == {"RTX": gk.RING_TILE["cols"],
                      "RTY": gk.RING_TILE["rows"],
                      "RBY": gk.RING_TILE["thread_rows"],
                      "RING_BLOCKS": gk.RING_TILE["blocks"],
                      "TTX": gk.TILED[1], "TTY": gk.TILED[0],
                      "TILED_BLOCKS": gk.TILED_BLOCKS,
                      "TILED_MIN_PLANES": gk.TILED_MIN_PLANES,
                      "NARROW_MIN_PLANES": gk.NARROW_MIN_PLANES}
    assert "constexpr int NBY = 8, NARROW_BLOCKS = 3;" in text
    assert "__launch_bounds__(BX * NBY, NARROW_BLOCKS)" in text
    assert (gk.NARROW, gk.NARROW_BLOCKS) == ((8, 32), 3)
    assert ("model::N_STAGES == 2 && model::stage_ext(0) <= 2\n"
            "    && model::N_STORAGE * BY * BX * sizeof(float) <= "
            "40 * 1024;") in text
    assert ("model::N_STAGES == 1 && model::N_STORAGE >= "
            "TILED_MIN_PLANES;") in text
    assert ("model::N_STAGES == 1 && !TILED_FORM\n"
            "                             && model::N_STORAGE >= "
            "NARROW_MIN_PLANES;") in text
    assert "constexpr bool STAGED_FORM = model::N_STAGES > 1 && " \
        "!RING_FORM;" in text
    for name in MODELS_2D:
        m = get_model(name)
        plan, _ = gk.action_plan(m)
        ring = (len(plan) == 2 and plan[0][1] <= 2
                and m.n_storage * 16 * 32 * 4 <= 40 * 1024)
        tiled = len(plan) == 1 and m.n_storage >= consts["TILED_MIN_PLANES"]
        narrow = (len(plan) == 1 and not tiled
                  and m.n_storage >= consts["NARROW_MIN_PLANES"])
        want = ("ring" if ring else "staged" if len(plan) > 1
                else "tiled" if tiled else "narrow" if narrow else "pass")
        assert gk.step_form(m) == want, name


@pytest.mark.parametrize("name", TILED)
def test_tiled_tile_shared_memory(name):
    """The tiled form's 32x8 tile stages every plane over the tile plus
    the reach (one node) in f32: npe_guo's 45 planes over 10x34 nodes take
    61,200 B; two blocks an SM fit its 228 KB (a KB each reserved), one
    block within 227 KB."""
    m = get_model(name)
    tt = gk.tiled_tile(m)
    assert tt["tile"] == (8, 32) and tt["halo"] == 1 == gk.action_plan(m)[1]
    assert tt["input"] == (10, 34) and tt["threads"] == 256
    assert tt["smem"] == 4 * m.n_storage * 10 * 34 == 61200
    assert tt["smem"] <= SMEM_LIMIT
    assert tt["blocks"] * (tt["smem"] + 1024) <= gk.SMEM_PER_SM


@pytest.mark.parametrize("name", RING)
def test_ring_tile_extents(name):
    """The ring form's tile: stage 0 on 32x32 nodes, two rows a thread of
    a 32x16 block, its planes in f32 shared memory (pf's 19: 77,824 B,
    kuper's 10: 40,960 B), two blocks' within an SM's 228 KB; stage 1
    on the inner 28x28 (pf, ring 2) or 30x30 (kuper, ring 1), so stage 0
    runs 1.31 or 1.14 times an output node (a 32x16 tile: 1.52, 1.22)."""
    m = get_model(name)
    rt = gk.ring_tile(m)
    ring = gk.action_plan(m)[0][0][1]
    assert rt["ring"] == ring and rt["stage0"] == (32, 32)
    assert rt["tile"] == (32 - 2 * ring, 32 - 2 * ring)
    assert rt["threads"] == 512 and 32 % gk.RING_TILE["thread_rows"] == 0
    assert rt["smem"] == 4 * m.n_storage * 32 * 32 == {
        "d2q9_pf_pressureEvolution": 77824, "d2q9_kuper": 40960}[name]
    assert rt["smem"] <= SMEM_LIMIT and rt["blocks"] == 2
    assert rt["blocks"] * (rt["smem"] + 1024) <= gk.SMEM_PER_SM
    assert rt["stage0_per_node"] == pytest.approx(
        {"d2q9_pf_pressureEvolution": 1024 / 784,
         "d2q9_kuper": 1024 / 900}[name])


ADJOINT_2D = ("d2q9_heat_adj", "d2q9_adj", "d2q9_optimalMixing",
              "d2q9_plate")


@pytest.mark.parametrize("model", ["d2q9_npe_guo", "d2q9_solid",
                                   "d2q9_pf_pressureEvolution",
                                   "d2q9_kuper", "d2q9_heat", "d2q9",
                                   "sw", "d2q9_poison_boltzmann"]
                         + list(ADJOINT_2D))
def test_parity_cut_variants_apply(tmp_path, model):
    """``generic2d_parity --cut``'s variants apply to this source: each
    replaces the one call of the header's stage in run_stage (or
    npe_guo's second pass) and leaves the rest of the copy as it was; an
    adjoint header's reverse variants cut generic2d_adjoint.cuh alone
    (its one call of stage_b<0>, its settings sum and its finish_sums); a
    header with globals also takes the globals variants: the node sums
    dropped from add_global, or reduce_globals returning after the
    block's partials (the variant a thread a global has nothing to cut in
    this source: its blocks already sum so, and the copy is not made)."""
    from tclb_tpu_torch.ops import generic2d_parity as gp
    header = gk.DEVICE_MODELS[model].header
    has_globals = bool(gk.DEVICE_MODELS[model].globals_)
    assert has_globals == (model != "d2q9_poison_boltzmann")
    want = ["full", "loads and stores"] + (
        ["stage 0 alone", "stage 1 alone"] if model in RING else []) + (
        ["pass 1 alone"] if model == "d2q9_npe_guo" else []) + (
        list(gp.GLOBALS_CUTS) if has_globals else []) + (
        list(gp.REVERSE_CUTS) if model in ADJOINT_2D else [])
    assert gp.cut_variants(model) == want
    assert gk.DEVICE_MODELS[model].adjoint == (model in ADJOINT_2D)
    src = _cuda_build.CSRC
    rev, common = "generic2d_adjoint.cuh", "generic_common.cuh"
    for i, variant in enumerate(want):
        dst = tmp_path / str(i)
        made = gp.cut_csrc(src, dst, model, variant)
        assert made == (variant != "partials a thread a global")
        assert dst.exists() == made
        if not made:
            continue
        cu, hd, b, cm = ((dst / f).read_text()
                         for f in ("generic2d.cu", header, rev, common))
        if variant not in gp.REVERSE_CUTS:
            assert b == _source(rev)
        if variant not in gp.GLOBALS_CUTS:
            assert cm == _source(common)
        if variant == "globals without sums":
            assert hd == _source(header) and cm == _source(common)
            assert gp.GLOBALS_SUM_HOOK not in cu
            assert cu == _source("generic2d.cu").replace(
                gp.GLOBALS_SUM_HOOK, gp.GLOBALS_CUTS[variant][1])
        elif variant == "block partials alone":
            assert cu == _source("generic2d.cu") and hd == _source(header)
            assert cm == _source(common).replace(gp.REDUCE_HOOK,
                                                 gp.REDUCE_CUT)
            body = cm[cm.index("__device__ void reduce_globals("):]
            assert body.index("return;") < body.index("atomicAdd(")
        elif variant == "full":
            assert cu == _source("generic2d.cu") and hd == _source(header)
        elif variant == "pass 1 alone":
            assert cu == _source("generic2d.cu")
            assert gp.NPE_PASS2 not in hd and gp.NPE_PASS1_ONLY in hd
        elif variant in gp.REVERSE_CUTS:
            assert cu == _source("generic2d.cu") and hd == _source(header)
            assert gp.B_SUM_HOOK not in b and "finish_sums<" not in b
            assert "sacc[i] +=" not in b and "sett_out[i] = t;" not in b
            # what is left of the kernel closes as it opened
            kernel = b[b.index("generic2d_step_b_kernel("):
                       b.index('extern "C"')]
            assert kernel.count("{") == kernel.count("}")
            assert kernel.count("(") == kernel.count(")")
            copy = variant == "reverse loads and stores"
            assert (gp.B_STAGE_HOOK in b) != copy
            assert (gp.B_COPY in b) == copy
        else:
            assert hd == _source(header)
            assert gp.CUT_HOOK not in cu and gp.CUTS[variant] in cu


class _FakeLib:
    """A library that records the arguments its step entries are handed
    and launches nothing."""

    def __init__(self):
        self.calls = []

    def generic2d_step(self, *args):
        self.calls.append(args)
        return 0

    generic2d_step_bf16 = generic2d_step

    def generic2d_step_blocks(self, ny, nx, bf16, series, device, out):
        out._obj.value = 4
        return 0


@pytest.mark.parametrize("name", STAGED + RING + ("d2q9_heat",))
def test_mid_only_for_a_plan_run_as_passes(monkeypatch, name):
    """No plan runs as passes any more, so a step hands its library no
    scratch stack (the wrapper has no ``_mid`` to ask for one: since the
    resident kernel keeps the earlier stages in shared memory too, no
    kernel takes one), and the partials and globals buffers only in the
    globals flavour: every form runs in one launch, the staged form's
    earlier stages in shared memory."""
    m = get_model(name)
    fake = _FakeLib()
    monkeypatch.setitem(gk._LIB, name, {"lib": fake, "tile": (16, 32)})
    monkeypatch.setattr(gk, "lib", lambda model: fake)
    monkeypatch.setattr(gk, "device_and_stream", lambda t: (0, 0))
    assert not hasattr(gk, "_mid")
    shape = (8, 40)
    f = torch.zeros((m.n_storage,) + shape, dtype=torch.float32)
    flags = torch.zeros(shape, dtype=torch.int32)
    a = gk.step_args(m, shape, np.zeros(len(m.settings)))
    ztab = torch.zeros((len(m.zonal_settings), a.zone_max))
    gk._launch_step(f, flags, ztab, a, with_globals=False)
    gk._launch_step(f, flags, ztab, a, with_globals=True)
    plain, glob = fake.calls
    assert len(plain) == len(glob) == 9
    assert plain[2] == flags.data_ptr() and plain[5] is None
    assert glob[5] is not None and glob[6] is not None


@pytest.mark.parametrize("edited,other", [
    ("d2q9_lee", "d2q9_pp_MCMP"), ("d2q9_npe_guo", "d2q9_solid")])
def test_build_digest_covers_the_reach(tmp_path, monkeypatch, edited,
                                       other):
    """A staged or tiled plan's reach lives in its header: editing it
    rebuilds the model's library (the digest covers the pre-included
    header) and no other model's."""
    import shutil
    shutil.copytree(_cuda_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_cuda_build, "CSRC", tmp_path / "csrc")
    heads = [gk.DEVICE_MODELS[n].header for n in (edited, other)]
    before = [_cuda_build.digest("generic2d", h) for h in heads]
    path = tmp_path / "csrc" / heads[0]
    text = path.read_text()
    reach = gk.action_plan(get_model(edited))[1]
    assert text.count(f"REACH = {reach};") == 1
    path.write_text(text.replace(f"REACH = {reach};",
                                 f"REACH = {reach + 1};"))
    after = [_cuda_build.digest("generic2d", h) for h in heads]
    assert after[0] != before[0] and after[1] == before[1]


class _PassRouteLib:
    """A library of the pass route's ABI that records its step calls: its
    step entries take ``mid`` after ``fout``, its ``generic2d_plan``
    reports 3 stages in 3 launches, its step tile is 16x32."""

    class _Fn:
        def __init__(self, body):
            self.body = body

        def __call__(self, *args):
            return self.body(*args)

    def __init__(self):
        self.calls = []

        def plan(stages, passes):
            stages._obj.value, passes._obj.value = 3, 3

        def layout(*vals):
            for v, x in zip(vals, (16, 32, 11, 5, 4, 1, 2, 1)):
                v._obj.value = x

        def step(*args):
            self.calls.append(args)
            return 0
        self.generic2d_plan = self._Fn(plan)
        self.generic2d_layout = self._Fn(layout)
        for name in ("generic2d_step", "generic2d_step_bf16",
                     "generic2d_step_series", "generic2d_resident"):
            setattr(self, name, self._Fn(step))


@pytest.mark.parametrize("entry,extra", [
    ("generic2d_step", ()), ("generic2d_step_bf16", ("shift",)),
    ("generic2d_step_series", ("row", "ts", 5, 2))])
@pytest.mark.parametrize("with_globals", [False, True])
def test_parity_binds_the_pass_route(monkeypatch, entry, extra,
                                     with_globals):
    """generic2d_parity's adapter hands a pass-route library the scratch
    stack after ``fout`` and, in the globals flavour, partials of its own
    with the carry row (one row more than its 16x32 blocks); it reports
    the library's launches a step and stages, and passes every other
    entry through."""
    from tclb_tpu_torch.ops import generic2d_parity as gp
    raw = _PassRouteLib()
    abi = gp.PassesAbi(raw, "d2q9_lee")
    made = {}

    def buffers(ny, nx, device):
        made["shape"] = (ny, nx, device)
        return (torch.zeros((11, ny, nx)),
                torch.zeros((-(-ny // 16) * -(-nx // 32) + 1, 1),
                            dtype=torch.float64))
    monkeypatch.setattr(abi, "_buffers", buffers)
    assert abi.passes == 3
    stages = ctypes.c_int(0)
    abi.generic2d_plan(ctypes.byref(stages))
    assert stages.value == 3
    assert abi.generic2d_resident is raw.generic2d_resident
    m = get_model("d2q9_lee")
    a = gk.step_args(m, (20, 70), np.zeros(len(m.settings)))
    args = ctypes.byref(a.c_struct)
    tail = ("partials" if with_globals else None, "gout", 0, "stream")
    assert getattr(abi, entry)("fin", "fout", "flags", "ztab", args,
                               *extra, *tail) == 0
    (call,) = raw.calls
    assert call[:2] == ("fin", "fout") and isinstance(call[2], int)
    assert call[3:6] == ("flags", "ztab", args)
    assert call[6:6 + len(extra)] == extra
    assert made["shape"] == (20, 70, 0)
    # its own partials, with the carry row, in the globals flavour
    assert isinstance(call[-4], int) if with_globals else call[-4] is None
    assert call[-3:] == ("gout", 0, "stream")


# --------------------------------------------------------------------------- #
# d2q9_step2 and its instrument
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("variant", ["full", "loads and stores",
                                     "step 1 alone"])
def test_d2q9_parity_cut_variants_apply(variant):
    """``d2q9_parity --cut``'s variants apply to csrc/d2q9.cu: in each
    definition of d2q9_step2_kernel (a build compiles one) they drop
    node_update calls only (all of them, or the second half: step 2's,
    which follow the barrier that ends step 1), and leave the rest of the
    source as it was."""
    from tclb_tpu_torch.ops import d2q9_parity as dp
    text = _source("d2q9.cu")
    cut = dp.cut_source(text, variant)
    bodies, cut_bodies = dp.kernel_bodies(text), dp.kernel_bodies(cut)
    assert len(bodies) == len(cut_bodies) == 2
    prev, cprev = 0, 0
    for (start, end), (cstart, cend) in zip(bodies, cut_bodies):
        assert cut[cprev:cstart] == text[prev:start]
        body, cbody = text[start:end], cut[cstart:cend]
        calls = len(dp._CALL.findall(body))
        assert calls >= 2 and calls % 2 == 0
        kept = {"full": calls, "loads and stores": 0,
                "step 1 alone": calls // 2}[variant]
        assert len(dp._CALL.findall(cbody)) == kept
        assert cbody.count("(void)0") == calls - kept
        if variant == "step 1 alone":
            first_sync = cbody.index("__syncthreads();",
                                     cbody.index("node_update(a, f, "))
            assert all(m.start() < first_sync
                       for m in dp._CALL.finditer(cbody))
        prev, cprev = end, cend
    assert cut[cprev:] == text[prev:]


def test_d2q9_parity_arguments(capsys):
    """``d2q9_parity``'s command line: an other ``csrc/`` and optional
    models, or ``--cut`` and a source; no source, or a model that is not
    a d2q9 build, prints the usage and exits 2; without a card ``main``
    returns 2 after parsing."""
    from tclb_tpu_torch.ops import d2q9_parity as dp
    cut, path, models = dp.parse_args(["some/csrc"])
    assert not cut and path.name == "csrc" and models == list(dp.MODELS)
    assert dp.MODELS == ("d2q9", "d2q9_SRT", "d2q9_les", "d2q9_inc",
                         "d2q9_cumulant", "d2q9_new")
    cut, path, models = dp.parse_args(["--cut", "x/csrc", "d2q9_new"])
    assert cut and path.is_absolute() and models == ["d2q9_new"]
    for bad in ([], ["--cut"], ["x/csrc", "d2q9_kuper"]):
        with pytest.raises(SystemExit) as hit:
            dp.parse_args(bad)
        assert hit.value.code == 2
    err = capsys.readouterr().err
    assert "d2q9_parity --cut SRC/csrc" in err
    assert "not a d2q9 build: ['d2q9_kuper']" in err
    if not torch.cuda.is_available():
        assert dp.main(["x/csrc"]) == 2


@pytest.mark.parametrize("model", ["d2q9", "d2q9_new"])
def test_d2q9_parity_build_flags(model):
    """The instrument builds each model as the port does: d2q9 without a
    define, a family model with its id and --fmad=false."""
    from tclb_tpu_torch.ops import d2q9_parity as dp
    flags = dp.flags_of(model)
    assert flags[:len(_cuda_build.NVCC_FLAGS)] == _cuda_build.NVCC_FLAGS
    extra = flags[len(_cuda_build.NVCC_FLAGS):]
    assert extra == (() if model == "d2q9" else
                     ("-DD2Q9_MODEL=5", "--fmad=false"))


def test_step2_tile_matches_the_source():
    """``d2q9_kernels.STEP2_NODE`` and ``STEP2_TILES`` are csrc/d2q9.cu's
    tiles: the node tile (a 32x16 block, one step-1 node a thread, the
    output its inner 30x14) for the builds the preprocessor selects
    (D2Q9_MODEL 0, 4, 5: d2q9, d2q9_cumulant, d2q9_new), the 32x8
    output tile of 256 threads for the others, each with its grid."""
    from tclb_tpu_torch.ops import d2q9_kernels as dk
    text = _source("d2q9.cu")
    ids = re.search(r"#if (D2Q9_MODEL == \d+(?: \|\| D2Q9_MODEL == \d+)*)"
                    r"\n#define STEP2_NODE_TILE 1\n#else\n"
                    r"#define STEP2_NODE_TILE 0\n#endif", text).group(1)
    node = {int(i) for i in re.findall(r"== (\d+)", ids)}
    assert {m for m, i in dk.MODEL_ID.items() if i in node} \
        == set(dk.STEP2_NODE)
    s1y, s1x = dk.STEP2_TILES["node"]["step1"]
    assert f"constexpr int S1X = {s1x}, S1Y = {s1y};" in text
    assert "constexpr int STEP2_THREADS = S1X * S1Y;" in text
    assert ("const dim3 grid((a->nx + S2X - 1) / S2X, "
            "(a->ny + S2Y - 1) / S2Y);") in text
    ty, tx = dk.STEP2_TILES["tile"]["tile"]
    assert f"#define TX {tx}\n#define TY {ty}\n" in text
    assert dk.STEP2_TILES["tile"]["threads"] == tx * ty
    assert ("d2q9_step2_kernel<<<grid, TX * TY, 0, "
            "(cudaStream_t)stream>>>(") in text


@pytest.mark.parametrize("model", ("d2q9",) + (
    "d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_cumulant", "d2q9_new"))
def test_d2q9_step2_shared_memory_budget(model):
    """d2q9_step2's shared memory: the node tile's 9 input planes over
    34x18 and step 1's 9 over 32x16, 4 B each (40,464 B: no opt-in beyond
    48 KB), stages 1.46 input nodes and updates 1.22 step-1 nodes an
    output node, its 512 threads each one step-1 node; the 32x8 tile
    also stages the statics over step 1's 34x10 (31,872 B, d2q9's two BC
    planes too: 34,592 B) and stages 1.69 and updates 1.33."""
    from tclb_tpu_torch.ops import d2q9_kernels as dk
    st = dk.step2_tile(model)
    ty, tx = st["tile"]
    assert st["step1"] == (ty + 2, tx + 2)
    assert st["input"] == (ty + 4, tx + 4)
    if model in dk.STEP2_NODE:
        assert st["tile"] == (14, 30) and st["threads"] == 512
        assert st["smem"] == 4 * 9 * (34 * 18 + 32 * 16) == 40464
        assert st["smem"] <= 48 * 1024
        assert st["staged_per_node"] == pytest.approx(612 / 420)
        assert st["step1_per_node"] == pytest.approx(512 / 420)
    else:
        assert st["tile"] == (8, 32) and st["threads"] == 256
        assert st["smem"] == (34592 if model == "d2q9" else 31872)
        assert st["staged_per_node"] == pytest.approx(432 / 256)
        assert st["step1_per_node"] == pytest.approx(340 / 256)


def test_step_b_tile_matches_the_source():
    """``generic_kernels.STEP_B_TILE`` is csrc/generic2d_adjoint.cuh's
    tile: q on 32x32, two blocks an SM in the launch bounds, 16 thread
    rows (two rows a thread) or, for a header of ``narrow_min_planes`` or
    more, 8 (four rows a thread), the output tile inside the one-node ring
    (the library's ``tile_b`` export, which sizes the wrapper's
    partials)."""
    text = _source("generic2d_adjoint.cuh")
    bt = gk.STEP_B_TILE
    assert (f"constexpr int B_NARROW_MIN_PLANES = "
            f"{bt['narrow_min_planes']};") in text
    assert f"constexpr int BQ = {bt['side']}, B_BLOCKS = {bt['blocks']};" \
        in text
    assert ("constexpr int BQ_ROWS = model::N_STORAGE >= B_NARROW_MIN_PLANES"
            f" ? {bt['narrow_rows']} : {bt['rows']};") in text
    assert "constexpr int B_RING = 1;" in text
    assert "constexpr int BTX = BQ - 2 * B_RING, BTY = BQ - 2 * B_RING;" \
        in text
    assert "__launch_bounds__(B_THREADS, B_BLOCKS)" in text
    assert "finish_sums<NS_SETT, B_THREADS, true>(" in text
    assert "*tile_y = BTY;" in text and "*tile_x = BTX;" in text
    assert ("const dim3 grid((a->nx + BTX - 1) / BTX, "
            "(a->ny + BTY - 1) / BTY);") in text


@pytest.mark.parametrize("name,smem,threads", [
    ("d2q9_heat_adj", 77824, 256), ("d2q9_adj", 40960, 512),
    ("d2q9_optimalMixing", 57344, 512), ("d2q9_plate", 36864, 512)])
def test_step_b_tile_shared_memory(name, smem, threads):
    """The reverse tile's q over 32x32 nodes in f32 shared memory: two
    blocks' within an SM's 228 KB; heat_adj's 19 planes on 256 threads
    (<= 128 registers), the others' 9-14 on 512 (<= 64); 1024 nodes of q
    for 900 output nodes (1.14; a 32x16 tile: 1.22), and at bench.py's
    512x1024 a launch of 35 x 18 blocks, each one partial row."""
    m = get_model(name)
    bt = gk.step_b_tile(m)
    assert bt["q"] == (32, 32) and bt["tile"] == (30, 30)
    assert bt["threads"] == threads and bt["smem"] == smem
    assert bt["blocks"] == 2
    assert bt["blocks"] * (bt["smem"] + 1024) <= gk.SMEM_PER_SM
    assert 65536 // (bt["blocks"] * bt["threads"]) == (
        128 if threads == 256 else 64)
    assert bt["q_per_node"] == pytest.approx(1024 / 900)
    ty, tx = bt["tile"]
    assert (math.ceil(512 / ty), math.ceil(1024 / tx)) == (18, 35)


# --------------------------------------------------------------------------- #
# generic3d_step's passes, generic3d_step_b's push and their instrument
# --------------------------------------------------------------------------- #

ADJOINT_3D = ("d3q19_adj",)


def _step_b3_tile() -> dict:
    """generic3d_step_b's grid as csrc/ lays it: ``B_PLANES`` and
    ``B_BLOCKS`` of generic3d_adjoint.cuh, ``BX`` and ``BY`` of
    generic3d.cu."""
    planes, blocks = map(int, re.search(
        r"constexpr int B_PLANES = (\d+), B_BLOCKS = (\d+);",
        _source("generic3d_adjoint.cuh")).groups())
    cols, rows = map(int, re.search(r"constexpr int BX = (\d+), BY = (\d+);",
                                    _source("generic3d.cu")).groups())
    return {"planes": planes, "blocks": blocks, "rows": rows, "cols": cols}


def _flat(text: str) -> str:
    """``text`` with every run of white space one blank."""
    return " ".join(text.split())


def test_step_b3_tile_matches_the_source():
    """csrc/generic3d_adjoint.cuh's reverse grid: a 32x8 block whose
    threads each walk eight z-planes, two blocks an SM in the launch
    bounds, the settings sums reduced all at once; the one launch's grid
    and the ``generic3d_step_b_tile`` export (which sizes the wrapper's
    partials) are both that tile; the reverse pushes each q to the node
    that pulls it, with no scratch and no gather kernel."""
    t = _step_b3_tile()
    assert t == {"planes": 8, "blocks": 2, "rows": 8, "cols": 32}
    text = _flat(_source("generic3d_adjoint.cuh"))
    assert "__launch_bounds__(BX * BY, B_BLOCKS)" in text
    assert "finish_sums<NS_SETT, BX * BY, true>(" in text
    assert ("grid((a->nx + BX - 1) / BX, (a->ny + BY - 1) / BY, "
            "(a->nz + B_PLANES - 1) / B_PLANES)") in text
    export = text[text.index("void generic3d_step_b_tile("):]
    export = export[:export.index("}")]
    assert re.findall(r"\*tile_(\w) = (\w+);", export) == [
        ("z", "B_PLANES"), ("y", "BY"), ("x", "BX")]
    assert text.count("<<<") == 1 and "gather_kernel" not in text
    assert "lam_in[to] = v;" in text and "float* q," not in text


@pytest.mark.parametrize("shape,blocks", [((32, 64, 256), (4, 8, 8)),
                                          ((64, 128, 256), (8, 16, 8)),
                                          ((9, 13, 37), (2, 2, 2))])
def test_step_b3_grid(monkeypatch, shape, blocks):
    """The reverse grid at the gradient paths' shapes, as the wrapper
    counts it from a library that exports the source's tile: bench.py's
    case at 32x64x256 in 256 blocks (one wave of two blocks on each of an
    H100's 132 SMs), 64x128x256 in 1024; every thread's registers within
    65536 / (2 x 256) = 128; a block's static shared memory each thread's
    17 settings sums (doubles, a column a thread: 34,816 B) and the
    reduction's warp and block sums, under the 48 KB a block may hold
    without opting in, two blocks within an SM's 227 KB."""
    t = _step_b3_tile()
    fake = _FakeLib3("d3q19_adj", tile_b=(t["planes"], t["rows"], t["cols"]))
    g3, _ = _bind3(monkeypatch, "d3q19_adj", fake)
    a = _inputs3("d3q19_adj", shape)[-1]
    assert g3.n_blocks_b(a) == math.prod(blocks)
    nz, ny, nx = shape
    assert blocks == (-(-nz // t["planes"]), -(-ny // t["rows"]),
                      -(-nx // t["cols"]))
    threads = t["rows"] * t["cols"]
    assert threads == 256 and 65536 // (t["blocks"] * threads) == 128
    n_sett = len(gk.DEVICE_MODELS["d3q19_adj"].settings)
    assert n_sett == 17
    text = _flat(_source("generic3d_adjoint.cuh"))
    assert "__shared__ double ssum[NS_SETT][BX * BY];" in text
    assert "sacc[i * (BX * BY)] += (double)v;" in text
    smem = 8 * n_sett * threads + 8 * n_sett * (threads // 32 + 1) + 1
    assert smem == 36041 <= 48 * 1024
    assert t["blocks"] * smem <= SMEM_LIMIT
    if shape == (32, 64, 256):
        assert math.prod(blocks) == 256 <= 2 * SMS


class _FakeLib3:
    """A generic 3D library that records the arguments its step entries are
    handed and launches nothing; its reverse grid is ``tile_b``.  Its
    entries are plain functions, so that a binder can set their ctypes
    attributes."""

    def __init__(self, model, tile_b=(8, 8, 32)):
        self.calls = []
        dm = gk.DEVICE_MODELS[model]
        sizes = [8, 32, len(dm.storage), len(dm.settings),
                 len(dm.node_types), len(dm.groups), len(dm.zonal),
                 len(dm.globals_)]

        def fill(values):
            def fn(*out):
                for ref, v in zip(out, values):
                    ref._obj.value = v
            return fn
        self.generic3d_layout = fill(sizes)
        self.generic3d_plan = fill([len(dm.plan)])
        self.generic3d_step_b_tile = fill(tile_b)
        self.generic_error_string = lambda code: b"fake"
        for name in ("generic3d_step", "generic3d_step_series",
                     "generic3d_step_b"):
            setattr(self, name, self._record(name))

    def _record(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _bind3(monkeypatch, model, lib):
    """``g3``'s entry for ``model`` bound to ``lib`` (no build)."""
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    entry = g3.bind(lib, model, "fake.so")
    monkeypatch.setitem(g3._LIB, model, entry)
    monkeypatch.setattr(gk, "device_and_stream", lambda t: (0, 0))
    return g3, entry


def _inputs3(model, shape):
    m = get_model(model)
    f = torch.zeros((m.n_storage,) + shape, dtype=torch.float32)
    flags = torch.zeros(shape, dtype=torch.int32)
    a = gk.step_args(m, shape, np.zeros(len(m.settings)))
    ztab = torch.zeros((len(m.zonal_settings), a.zone_max))
    return m, f, flags, ztab, a


@pytest.mark.parametrize("shape", [(32, 64, 256), (9, 13, 37)])
def test_step_b3_partials_sized_by_the_grid(monkeypatch, shape):
    """The wrapper reads the reverse grid from the library (``tile_b``)
    and hands ``generic3d_step_b`` one partial row per block of it, no
    scratch stack, in one launch."""
    from tclb_tpu_torch.ops import adjoint_kernels as ak
    fake = _FakeLib3("d3q19_adj")
    g3, entry = _bind3(monkeypatch, "d3q19_adj", fake)
    assert entry["tile_b"] == (8, 8, 32) and entry["passes"] == 1
    m, f, flags, ztab, a = _inputs3("d3q19_adj", shape)
    made = []
    real_empty = torch.empty

    def empty(*args, **kw):
        t = real_empty(*args, **kw)
        made.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "empty", empty)
    ak.reset_launches()
    lam_g = torch.zeros((m.n_globals,))
    ak._launch_step_b_3d(f, flags, ztab, a, torch.zeros_like(f), lam_g)
    (name, args), = fake.calls
    assert name == "generic3d_step_b" and len(args) == 11
    tz, ty, tx = entry["tile_b"]
    nz, ny, nx = shape
    blocks = -(-nz // tz) * -(-ny // ty) * -(-nx // tx)
    assert g3.n_blocks_b(a) == blocks
    assert (blocks, len(m.settings)) in made
    assert made.count(f.shape) == 0          # lam_in: empty_like
    assert ak.LAUNCHES["generic3d_step_b"] == 1


@pytest.mark.parametrize("name", ["d3q19_kuper", "d3q19_adj",
                                  "d3q19_heat"])
def test_generic3d_step_takes_no_scratch(monkeypatch, name):
    """No 3D plan hands its stages' planes on through a scratch stack: the
    step entries take none (the wrappers have no ``_mid`` to ask for
    one), a call counts one launch a stage (d3q19_kuper: two), and the
    partials (with the carry row) and globals only in the globals
    flavour."""
    fake = _FakeLib3(name)
    g3, entry = _bind3(monkeypatch, name, fake)
    assert not hasattr(gk, "_mid")
    m, f, flags, ztab, a = _inputs3(name, (4, 8, 40))
    g3.reset_launches()
    g3._launch_step(f, flags, ztab, a, with_globals=False)
    g3._launch_step(f, flags, ztab, a, with_globals=True)
    (_, plain), (_, glob) = fake.calls
    assert len(plain) == len(glob) == 9
    assert plain[:4] == (f.data_ptr(), plain[1], flags.data_ptr(),
                         ztab.data_ptr())
    assert plain[5] is None and glob[5] is not None and glob[6] is not None
    passes = len(gk.DEVICE_MODELS[name].plan)
    assert entry["passes"] == passes == (2 if name == "d3q19_kuper" else 1)
    assert g3.LAUNCHES == {"generic3d_step": 2 * passes}


def test_generic3d_passes_hand_planes_on_in_the_output():
    """csrc/generic3d.cu: a stage reads an earlier stage's planes from the
    step's output (no scratch stack), requires every stage's write set
    disjoint from the earlier ones', and the last pass copies only the
    planes no stage writes; d3q19_kuper's two write sets are disjoint and
    cover its 20 planes."""
    text = _source("generic3d.cu")
    assert "mid" not in re.sub(r"//.*", "", text)
    assert "static_assert(stages_disjoint()," in text
    assert "for (int s = 1; s <= LAST; ++s)" in text
    assert "Storage3{fout, a.nz, a.ny, a.nx}" in text
    assert ("if (!(((writes_before(LAST) >> k) & 1ull) || writes(LAST, k)))"
            in text)
    header = (_cuda_build.CSRC / "models" / "d3q19_kuper.cuh").read_text()
    run, phi = (int(v, 16) for v in re.search(
        r"stage_writes\(int s\) \{\s*return s == 0 \? (0x[0-9a-fA-F]+)u"
        r" : (0x[0-9a-fA-F]+)u;", header).groups())
    storage = gk.DEVICE_MODELS["d3q19_kuper"].storage
    assert [k for k in range(len(storage)) if run >> k & 1] == [
        k for k, name in enumerate(storage) if name.startswith("f[")]
    assert phi == 1 << storage.index("phi")
    assert run & phi == 0 and run | phi == (1 << len(storage)) - 1


def test_generic3d_parity_cut_variants_apply(tmp_path):
    """``generic3d_parity --cut``'s variants apply to this source: the
    forward ones replace the one call of the header's stage in
    generic3d.cu, keeping its template argument; the reverse ones cut
    generic3d_adjoint.cuh alone (its one call of stage_b<0>, settings sum
    and finish_sums); "q kernel alone" is offered only for a source with
    a gather kernel, applies to one (a copy of this csrc/ with a gather
    launch written in) and fails loudly on this source, which has none."""
    from tclb_tpu_torch.ops import generic3d_parity as gp
    src = _cuda_build.CSRC
    assert gp.cut_variants("d3q19_kuper") == [
        "full", "loads and stores", "stage 0 alone", "stage 1 alone"]
    assert gp.cut_variants("d3q19_adj") == [
        "full", "loads and stores", "reverse loads and stores",
        "reverse without settings sums"]
    rev = "generic3d_adjoint.cuh"
    for model in ("d3q19_kuper", "d3q19_adj"):
        for i, variant in enumerate(gp.cut_variants(model)):
            dst = tmp_path / f"{model}_{i}"
            gp.cut_csrc(src, dst, model, variant)
            cu, b = ((dst / f).read_text() for f in ("generic3d.cu", rev))
            if variant == "full":
                assert cu == _source("generic3d.cu") and b == _source(rev)
            elif variant in gp.REVERSE_CUTS:
                assert cu == _source("generic3d.cu")
                assert not gp.B_SUM_HOOK.search(b)
                assert "finish_sums<" not in b
                kernel = b[b.index("generic3d_step_b_kernel("):
                           b.index('extern "C"')]
                assert kernel.count("{") == kernel.count("}")
                assert kernel.count("(") == kernel.count(")")
                copy = variant == "reverse loads and stores"
                assert (gp.B_STAGE_HOOK in b) != copy
                assert (gp.B_COPY in b) == copy
            else:
                assert b == _source(rev)
                assert not gp.CUT_HOOK.search(cu) or variant != \
                    "loads and stores"
                assert gp.CUTS[variant].replace("{S}", "kStage") in cu
    with pytest.raises(SystemExit):
        gp.cut_csrc(src, tmp_path / "q", "d3q19_adj", "q kernel alone")
    two = tmp_path / "two"
    import shutil
    shutil.copytree(src, two)
    path = two / rev
    path.write_text(path.read_text().replace(
        "  return (int)cudaGetLastError();\n}\n\n}  // extern",
        "  generic3d_step_b_gather_kernel<<<grid, block, 0, s>>>(\n"
        "      q, lam_out, *a, lam_in);\n"
        "  return (int)cudaGetLastError();\n}\n\n}  // extern"))
    assert "q kernel alone" in gp.cut_variants("d3q19_adj", two)
    gp.cut_csrc(two, tmp_path / "two_cut", "d3q19_adj", "q kernel alone")
    assert "gather_kernel<<<" not in (tmp_path / "two_cut" / rev).read_text()


def test_generic3d_parity_arguments(capsys):
    """``generic3d_parity``'s command line: an other ``csrc/`` and
    optional models, or ``--cut`` and a source; nothing, or ``--cut``
    alone, prints the usage and exits 2; without a card each form returns
    2 after parsing."""
    from tclb_tpu_torch.ops import generic3d_parity as gp
    for bad in ([], ["--cut"]):
        assert gp.main(bad) == 2
    assert "generic3d_parity --cut SRC/csrc" in capsys.readouterr().err
    assert gp.CUT_MODELS == ("d3q19_kuper", "d3q19_adj")
    assert gp.STEP_B_SHAPES == ((32, 64, 256), (64, 128, 256))
    if not torch.cuda.is_available():
        for good in (["x/csrc"], ["--cut", "x/csrc", "d3q19_kuper"]):
            assert gp.main(good) == 2


@pytest.mark.parametrize("with_globals", [False, True])
def test_parity_binds_the_scratch_abi(monkeypatch, with_globals):
    """``generic3d_parity`` binds a copy whose step entries take the
    scratch stack ``mid`` and whose ``generic3d_step_b`` takes ``q``
    through ``ScratchAbi3``: the wrapper's calls reach it with those
    stacks and partials of its own grid (a 32x8 block a z-plane, the
    carry row after the forward's), and its reverse grid reads as one
    z-plane a block."""
    from tclb_tpu_torch.ops import generic3d_parity as gp
    made = {}
    real_empty = torch.empty

    def empty(shape, **kw):
        made.setdefault("shapes", []).append(tuple(shape))
        return real_empty(shape)
    monkeypatch.setattr(torch, "empty", empty)

    raw = _FakeLib3("d3q19_adj")
    abi = gp.ScratchAbi3(raw, "d3q19_adj")
    entry = gp.g3.bind(abi, "d3q19_adj", "old.so")
    assert entry["tile_b"] == (1, 8, 32)

    class _Args:
        nz, ny, nx = 4, 10, 40

    class _Ref:
        _obj = _Args()
    args = _Ref()
    tail = ("partials" if with_globals else None, "gout", 0, "stream")
    monkeypatch.setattr(torch, "device", lambda *a: "cpu")
    assert abi.generic3d_step("fin", "fout", "flags", "ztab", args,
                              *tail) == 0
    assert abi.generic3d_step_b("fin", "lam", "flags", "ztab", args, "lg",
                                "lam_in", "part", "sett", 0, "s") == 0
    (n1, step), (n2, back) = raw.calls
    assert n1 == "generic3d_step" and n2 == "generic3d_step_b"
    assert step[:2] == ("fin", "fout") and isinstance(step[2], int)
    assert step[3:6] == ("flags", "ztab", args)
    assert isinstance(step[6], int) if with_globals else step[6] is None
    assert step[7:] == ("gout", 0, "stream")
    assert back[:7] == ("fin", "lam", "flags", "ztab", args, "lg", "lam_in")
    assert isinstance(back[7], int) and isinstance(back[8], int)
    assert back[9:] == ("sett", 0, "s")
    blocks = 4 * 2 * 2
    dm = gk.DEVICE_MODELS["d3q19_adj"]
    assert made["shapes"] == [(20, 4, 10, 40),
                              (blocks + 1, len(dm.globals_)),
                              (blocks, len(dm.settings))]
