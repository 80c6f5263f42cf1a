"""Flag fields and states shared by the port's tests (numpy only, so the
tests that run on the card can use them without JAX)."""

import numpy as np

# tests/test_fastpath.py's settings for the Kármán flags below
KARMAN_SETTINGS = {"nu": 0.05, "Velocity": 0.03}
# a body force as well, so the kernels' forcing terms count
RICH_SETTINGS = {"nu": 0.05, "Velocity": 0.03, "GravitationX": 2e-5,
                 "GravitationY": -1e-5}


def karman_flags(m, ny=64, nx=128):
    """tests/test_fastpath.py's Kármán flags: W velocity inlet, E pressure
    outlet, channel walls, a block obstacle and objective columns."""
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = m.flag_for("Wall")
    flags[-1, :] = m.flag_for("Wall")
    flags[ny // 3:2 * ny // 3, nx // 8:nx // 4] = m.flag_for("Wall")
    flags[1:-1, 2] = m.flag_for("MRT", "Inlet")
    flags[1:-1, -3] = m.flag_for("MRT", "Outlet")
    return flags


def rich_flags(m, ny, nx):
    """Every boundary case the kernels dispatch, zonal in/outlets (zone 1
    velocity, zone 2 density), the objective columns, and a
    painted-but-unhandled WPressureL node."""
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT", zone=1)
    flags[:, -1] = m.flag_for("EPressure", "MRT", zone=2)
    flags[: ny // 2, 1] = m.flag_for("WPressure", "MRT", zone=2)
    flags[ny // 2:, -2] = m.flag_for("EVelocity", "MRT", zone=1)
    flags[0, :] = m.flag_for("BottomSymmetry", "MRT")
    flags[-1, :] = m.flag_for("TopSymmetry", "MRT")
    flags[ny // 3:2 * ny // 3, nx // 8:nx // 4] = m.flag_for("Wall")
    flags[ny // 3, nx // 2] = m.flag_for("Solid")
    flags[ny // 2, nx // 2] = m.flag_for("WPressureL", "MRT")
    flags[2:-2, 3] = m.flag_for("MRT", "Inlet")
    flags[2:-2, -4] = m.flag_for("MRT", "Outlet")
    return flags


def random_planes(m, shape, seed):
    """Populations near a flowing equilibrium plus noise, and nonzero BC
    coupling planes (so the in-collision forcing counts)."""
    rng = np.random.default_rng(seed)
    E = m.ei[:9, :2].astype(np.float64)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.03 + 0.01 * rng.standard_normal((2,) + shape)
    planes = {}
    for k in range(9):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1]
        feq = w[k] * rho * (1 + 3 * eu + 4.5 * eu * eu
                            - 1.5 * (u * u).sum(0))
        planes[f"f[{k}]"] = feq * (1 + 0.02 * rng.standard_normal(shape))
    planes["BC[0]"] = 1e-4 * rng.standard_normal(shape)
    planes["BC[1]"] = 1e-4 * rng.standard_normal(shape)
    return planes


def paint_rich(lat, seed):
    """``rich_flags`` with zonal Velocity/Density and ``random_planes`` on
    a Lattice of either package."""
    lat.set_flags(rich_flags(lat.model, *lat.shape))
    lat.set_setting("Velocity", 0.04, zone=1)
    lat.set_setting("Density", 1.002, zone=2)
    lat.init()
    lat.set_density_planes(random_planes(lat.model, lat.shape, seed))
    return lat


# d3q27_cumulant: a forced channel with every boundary case and a Buffer
# layer, settings zone 1 velocity + turbulence, zone 2 density
RICH3D_SETTINGS = {"nu": 0.05, "ForceX": 1e-5, "GravitationZ": -2e-6,
                   "nubuffer": 0.08}
SHAPE3D = (12, 8, 64)


def rich_flags_3d(m, nz, ny, nx):
    """Every node type ``d3q27_cumulant`` dispatches, painted on a
    (nz, ny, nx) field: W/E velocity, pressure and the turbulent inlet on
    the x faces, N/S velocity, pressure and symmetry on the y faces, walls,
    a solid node, an unhandled WPressureL node, objective columns, BGK
    collision nodes, and a Buffer layer (ADDITIONALS) over MRT nodes."""
    f = m.flag_for
    flags = np.full((nz, ny, nx), f("MRT"), dtype=np.uint16)
    h = nz // 2
    q = nz // 4
    flags[:, :, 0] = f("WVelocity", "MRT", zone=1)
    flags[:h, :, 1] = f("WPressure", "MRT", zone=2)
    flags[h:, :, 1] = f("WVelocityTurbulent", "MRT", zone=1)
    flags[:, :, -1] = f("EPressure", "MRT", zone=2)
    flags[h:, :, -2] = f("EVelocity", "MRT", zone=1)
    flags[:q, 0, 2:-2] = f("SSymmetry", "MRT")
    flags[q:h, 0, 2:-2] = f("SVelocity", "MRT", zone=1)
    flags[h:, 0, 2:-2] = f("SPressure", "MRT", zone=2)
    flags[:q, -1, 2:-2] = f("NSymmetry", "MRT")
    flags[q:h, -1, 2:-2] = f("NVelocity", "MRT", zone=1)
    flags[h:, -1, 2:-2] = f("NPressure", "MRT", zone=2)
    flags[q:q + 3, 3:5, nx // 4:nx // 4 + 4] = f("Wall")
    flags[0, ny // 2, 3 * nx // 4] = f("Solid")
    flags[h, ny // 2, nx // 2] = f("WPressureL", "MRT")
    flags[1:-1, 2:-2, 4] = f("MRT", "Inlet")
    flags[1:-1, 2:-2, -5] = f("MRT", "Outlet")
    flags[:, 2:-2, 6:9] = f("BGK")
    flags[:, 1:-1, nx - 12:nx - 8] |= np.uint16(f("Buffer"))
    return flags


def random_planes_3d(m, shape, seed):
    """d3q27 populations near a flowing equilibrium plus noise, nonzero
    SynthT planes (so the turbulent inlet counts) and nonzero averages."""
    rng = np.random.default_rng(seed)
    E = m.ei[:27].astype(np.float64)
    w = np.array([{0: 8 / 27, 1: 2 / 27, 2: 1 / 54, 3: 1 / 216}[
        int((e * e).sum())] for e in E])
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    u[0] += 0.03
    usq = (u * u).sum(0)
    planes = {}
    for k in range(27):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1] + E[k, 2] * u[2]
        feq = w[k] * rho * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
        planes[f"f[{k}]"] = feq * (1 + 0.02 * rng.standard_normal(shape))
    for name in ("SynthTX", "SynthTY", "SynthTZ"):
        planes[name] = rng.standard_normal(shape)
    for name in ("avgP", "avgUX", "avgUY", "avgUZ"):
        planes[name] = 0.01 * rng.standard_normal(shape)
    return planes


def paint_rich_3d(lat, seed):
    """``rich_flags_3d`` with zonal Velocity/Turbulence/Density and
    ``random_planes_3d`` on a Lattice of either package."""
    lat.set_flags(rich_flags_3d(lat.model, *lat.shape))
    lat.set_setting("Velocity", 0.04, zone=1)
    lat.set_setting("Turbulence", 0.05, zone=1)
    lat.set_setting("Density", 1.002, zone=2)
    lat.init()
    lat.set_density_planes(random_planes_3d(lat.model, lat.shape, seed))
    return lat


# d2q9_kuper: example/drop.xml's liquid and vapour and its EOS, a wall and
# a moving wall, the symmetry mirrors, a solid block, a colliding wall node
# (the force's wall term) and a second density zone on the boundaries
KUPER_SETTINGS = {"omega": 1.0, "Temperature": 0.56, "FAcc": 1.0,
                  "Magic": 0.01, "MagicA": -0.152, "MagicF": -2.0 / 3.0,
                  "Density": 3.2600529440452366, "MovingWallVelocity": 0.01,
                  "GravitationX": 1e-5, "GravitationY": -2e-6}
KUPER_SHAPE = (16, 128)
KUPER_VAPOUR = 0.014500641645077492    # drop.xml's Density-zdrop
KUPER_WALL_DENSITY = 2.0


def rich_flags_kuper(m, ny, nx):
    """Every node type ``d2q9_kuper`` dispatches on a (ny, nx) field: a
    vapour drop (zone 1) in the liquid, a Wall row and a MovingWall row
    (zone 2), SSymmetry and NSymmetry nodes, a Solid block and a Wall
    node that keeps its MRT collision."""
    f = m.flag_for
    flags = np.full((ny, nx), f("MRT"), dtype=np.uint16)
    yy, xx = np.mgrid[0:ny, 0:nx]
    # an ellipse clear of the colliding wall node at x = nx / 8, which the
    # wall momentum term would blow up in the vapour
    drop = ((yy - ny / 2) / (ny / 4)) ** 2 + ((xx - nx / 3) / (nx / 8)) ** 2 < 1
    flags[drop] = f("MRT", zone=1)
    flags[0, :] = f("Wall", zone=2)
    flags[-1, :] = f("MovingWall", zone=2)
    flags[1, nx // 2:] = f("SSymmetry", "MRT")
    flags[-2, nx // 2:] = f("NSymmetry", "MRT")
    flags[ny // 2 - 2:ny // 2 + 2, 3 * nx // 4:3 * nx // 4 + 4] = \
        f("Solid", zone=2)
    flags[ny // 2, nx // 8] = f("Wall", "MRT")
    return flags


def paint_rich_kuper(lat, seed):
    """``rich_flags_kuper`` with the zonal densities on a Lattice of either
    package, initialised, then its populations perturbed by 1% noise."""
    lat.set_flags(rich_flags_kuper(lat.model, *lat.shape))
    lat.set_setting("Density", KUPER_VAPOUR, zone=1)
    lat.set_setting("Density", KUPER_WALL_DENSITY, zone=2)
    lat.init()
    rng = np.random.default_rng(seed)
    f = lat.fields_raw()
    lat.set_density_planes({
        f"f[{k}]": f[k] * (1 + 0.01 * rng.standard_normal(lat.shape))
        for k in range(9)})
    return lat


# d2q9_heat / d2q9_heat_adj: example/heat_adj.xml's settings with a heat
# source and a drag weight, so every term of the step counts
HEAT_SETTINGS = {"nu": 0.05, "InletVelocity": 0.02, "InletTemperature": 1.0,
                 "InitTemperature": 0.0, "FluidAlfa": 0.05,
                 "SolidAlfa": 0.005, "HeatSource": 1e-3,
                 "HeatFluxInObj": 1.0, "DragInObj": 0.3,
                 "MaterialInObj": 0.1}
HEAT_SHAPE = (32, 64)       # example/heat_adj.xml's ny x nx
HEAT_ZERO_UX = (12, 30)     # a collision node with ux == 0 and w < 1


def rich_flags_heat(m, ny, nx):
    """Every node type ``d2q9_heat_adj`` reads on a (ny, nx) field: a W
    velocity inlet, an E pressure outlet, channel walls, a Solid block, an
    Outlet column over MRT and a DesignSpace block; for ``d2q9_heat`` a
    Heater patch in place of the design space."""
    f = m.flag_for
    flags = np.full((ny, nx), f("MRT"), dtype=np.uint16)
    flags[:, 0] = f("WVelocity", "MRT")
    flags[:, -1] = f("EPressure", "MRT")
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[ny // 2 - 2:ny // 2 + 1, nx // 8:nx // 8 + 3] = f("Solid")
    flags[1:-1, -3] = f("MRT", "Outlet")
    extra = "Heater" if "Heater" in m.node_types else "DesignSpace"
    flags[ny // 4:3 * ny // 4, nx // 4:3 * nx // 4] |= np.uint16(f(extra))
    return flags


def heat_planes(m, shape, seed):
    """Populations of a flowing, warm state with 1% noise and, where the
    model has one, a design field w in [0.1, 1] (1 off the design
    space)."""
    rng = np.random.default_rng(seed)
    E = m.ei[:9, :2].astype(np.float64)
    wt = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.02 + 0.01 * rng.standard_normal((2,) + shape)
    temp = 0.5 + 0.3 * rng.random(shape)
    planes = {}
    for k in range(9):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1]
        feq = wt[k] * rho * (1 + 3 * eu + 4.5 * eu * eu
                             - 1.5 * (u * u).sum(0))
        planes[f"f[{k}]"] = feq * (1 + 0.01 * rng.standard_normal(shape))
        planes[f"T[{k}]"] = wt[k] * temp * (1 + 3 * eu) \
            * (1 + 0.01 * rng.standard_normal(shape))
    if "w" in m.storage_index:
        planes["w"] = 0.1 + 0.9 * rng.random(shape)
    return planes


def zero_ux_node(m, planes, node):
    """Make the pulled x momentum at ``node`` exactly 0 (in any rounding):
    f[1] and f[3] stream in equal, f[5..8] stream in equal."""
    y, x = node
    ny, nx = planes["f[0]"].shape
    E = m.ei[:9, :2]
    for k, value in ((1, 0.11), (3, 0.11), (5, 0.028), (6, 0.028),
                     (7, 0.028), (8, 0.028)):
        sy, sx = (y - int(E[k, 1])) % ny, (x - int(E[k, 0])) % nx
        planes[f"f[{k}]"][sy, sx] = value
    return planes


def paint_rich_heat(lat, seed):
    """``rich_flags_heat`` and ``heat_planes`` on a Lattice of either
    package, initialised first; d2q9_heat_adj's ``HEAT_ZERO_UX`` node gets
    ux == 0 and w == 0.5; a Heater zone pins 1.5 on d2q9_heat."""
    m = lat.model
    lat.set_flags(rich_flags_heat(m, *lat.shape))
    if "HeaterTemperature" in m.setting_index:
        lat.set_setting("HeaterTemperature", 1.5)
    lat.init()
    planes = heat_planes(m, lat.shape, seed)
    if "w" in planes:
        planes = zero_ux_node(m, planes, HEAT_ZERO_UX)
        planes["w"][HEAT_ZERO_UX] = 0.5
    lat.set_density_planes(planes)
    return lat


def heat_adj_golden_columns(solver):
    """tests/test_golden.py's gradient columns of the heat_adj case, on a
    port solver after its run: the 20-step unsteady gradient (levels 2) of
    HeatFlux + 0.1 Material over the design, its L1 norm and two probes
    in the design strip."""
    from tclb_tpu_torch.adjoint import (InternalTopology,
                                        make_unsteady_gradient)
    lat = solver.lattice
    lat.set_setting("HeatFluxInObj", 1.0)
    lat.set_setting("MaterialInObj", 0.1)
    design = InternalTopology(solver.model)
    grad_fn = make_unsteady_gradient(solver.model, design, 20, levels=2,
                                     shape=lat.shape, dtype=lat.dtype,
                                     device=lat.device)
    obj, g, _ = grad_fn(design.get(lat.state, lat.params), lat.state,
                        lat.params)
    g = g.double().cpu().numpy()
    cols = {"AdjObjective": float(obj), "AdjGradL1": float(np.abs(g).sum()),
            "AdjGradP1": float(g[0, 8, 12]), "AdjGradP2": float(g[0, 10, 20])}
    return cols, grad_fn.engine_name


# d3q19_adj: every node type the model dispatches, two zones (zone 1 a
# faster inlet and a lower Porocity, zone 2 a denser outlet), a body force,
# a compressible design law (PorocityGamma) and every global in the
# objective, so every term of the step and its reverse counts
ADJ3D_SETTINGS = {"nu": 0.05, "Velocity": 0.02, "Porocity": 0.5,
                  "PorocityGamma": 0.3, "S_high": 1.2,
                  "GravitationX": 1e-5, "GravitationY": -2e-6,
                  "GravitationZ": 3e-6, "DragInObj": 1.0,
                  "LiftInObj": 0.5, "MaterialInObj": 0.1,
                  "MaterialPenaltyInObj": 0.05, "PressureLossInObj": 0.2,
                  "OutletFluxInObj": 0.3, "InletFluxInObj": 0.4}
ADJ3D_SHAPE = (8, 16, 32)      # nz, ny, nx


def rich_flags_adj3d(m, nz, ny, nx):
    """Every node type ``d3q19_adj`` reads on a (nz, ny, nx) field: W
    velocity and pressure, E pressure and velocity, S and N symmetry,
    walls, a solid node, BGK and MRT collision, Inlet and Outlet columns
    and a DesignSpace block, half of it in Porocity zone 1."""
    f = m.flag_for
    flags = np.full((nz, ny, nx), f("MRT"), dtype=np.uint16)
    h = nz // 2
    flags[:h, :, 0] = f("WVelocity", "MRT", zone=1)
    flags[h:, :, 0] = f("WPressure", "MRT", zone=2)
    flags[:h, :, -1] = f("EPressure", "MRT", zone=2)
    flags[h:, :, -1] = f("EVelocity", "MRT", zone=1)
    flags[:, 0, 1:-1] = f("SSymmetry", "MRT")
    flags[:, -1, 1:-1] = f("NSymmetry", "MRT")
    flags[2:4, 5:8, 6:9] = f("Wall")
    flags[h, ny // 2, 3 * nx // 4] = f("Solid")
    flags[:, 2:-2, 3:5] = f("BGK")
    flags[1:-1, 1:-1, 2] = f("MRT", "Inlet")
    flags[1:-1, 1:-1, -3] = f("MRT", "Outlet")
    x0, x1 = nx // 3, 2 * nx // 3
    flags[1:-1, 3:-3, x0:x1] = f("MRT", "DesignSpace")
    flags[1:-1, 3:-3, x0:(x0 + x1) // 2] = f("MRT", "DesignSpace", zone=1)
    return flags


def adj3d_planes(m, shape, seed):
    """d3q19 populations near a flowing equilibrium with 2% noise and a
    design field w in (0.1, 0.9)."""
    rng = np.random.default_rng(seed)
    E = m.ei[:19].astype(np.float64)
    wt = np.array([{0: 1 / 3, 1: 1 / 18, 2: 1 / 36}[int((e * e).sum())]
                   for e in E])
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.01 * rng.standard_normal((3,) + shape)
    u[0] += 0.02
    usq = (u * u).sum(0)
    planes = {}
    for k in range(19):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1] + E[k, 2] * u[2]
        feq = wt[k] * rho * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
        planes[f"f[{k}]"] = feq * (1 + 0.02 * rng.standard_normal(shape))
    planes["w"] = 0.1 + 0.8 * rng.random(shape)
    return planes


def paint_rich_adj3d(lat, seed):
    """``rich_flags_adj3d`` with its zones and ``adj3d_planes`` on a
    Lattice of either package (d3q19_adj, or d3q19 without the design
    field)."""
    lat.set_flags(rich_flags_adj3d(lat.model, *lat.shape))
    lat.set_setting("Velocity", 0.03, zone=1)
    if "Porocity" in lat.model.setting_index:     # d3q19 has none
        lat.set_setting("Porocity", 0.2, zone=1)
    lat.set_setting("Density", 1.002, zone=2)
    lat.init()
    planes = adj3d_planes(lat.model, lat.shape, seed)
    if "w" not in lat.model.storage_index:
        del planes["w"]
    lat.set_density_planes(planes)
    return lat


# The 3D adjoint case: the analogue of example/heat_adj.xml for d3q19_adj
# at bench.py's 32x64x256 (bench.py:418-428): a W velocity inlet, an E
# pressure outlet, channel walls on y (periodic in z), bench.py's
# DesignSpace block (the middle half in y and z, the middle third in x),
# bench.py's settings; a Solve, an FD check, an MMA Optimize under a
# material constraint, ThresholdNow and VTK.
ADJ3D_CASE_SIZES = {
    "chip": dict(nz=32, ny=64, nx=256, solve=2000, fd_iter=8, fd_checks=3,
                 evals=5, opt_iter=200),
    "test": dict(nz=8, ny=16, nx=32, solve=50, fd_iter=4, fd_checks=2,
                 evals=2, opt_iter=8),
}


def adj3d_case_xml(size="test", out="output/"):
    """The case XML at one of ``ADJ3D_CASE_SIZES``."""
    s = ADJ3D_CASE_SIZES[size]
    nz, ny, nx = s["nz"], s["ny"], s["nx"]
    return f"""<?xml version="1.0"?>
<CLBConfig version="2.0" model="d3q19_adj" output="{out}">
    <Geometry nx="{nx}" ny="{ny}" nz="{nz}">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Box nx="1"/></WVelocity>
        <EPressure name="Outlet"><Box dx="-1"/></EPressure>
        <Wall mask="ALL"><Channel/></Wall>
        <DesignSpace><Box dx="{nx // 3}" nx="{nx // 3}" dy="{ny // 4}"
            ny="{ny // 2}" dz="{nz // 4}" nz="{nz // 2}"/></DesignSpace>
    </Geometry>
    <Model>
        <Params Velocity="0.02" nu="0.05"/>
        <Params Porocity="0.5" DragInObj="1"/>
    </Model>
    <Solve Iterations="{s['solve']}"/>
    <FDTest Iterations="{s['fd_iter']}" Checks="{s['fd_checks']}"/>
    <Optimize Method="MMA" MaxEvaluations="{s['evals']}"
              Iterations="{s['opt_iter']}" Material="less">
        <InternalTopology/>
    </Optimize>
    <ThresholdNow/>
    <VTK/>
</CLBConfig>
"""


def adj3d_design_block(shape):
    """The case's DesignSpace block as (z, y, x) slices."""
    nz, ny, nx = shape
    return (slice(nz // 4, nz // 4 + nz // 2),
            slice(ny // 4, ny // 4 + ny // 2),
            slice(nx // 3, nx // 3 + nx // 3))


def bench_adjoint3d_lattice(lattice_cls, model, dtype, shape=(32, 64, 256),
                            **kw):
    """bench.py:bench_adjoint3d's case (bench.py:418-428) on a Lattice of
    either package: MRT everywhere, walls on y, periodic x and z, the
    DesignSpace block, nu 0.05, Velocity 0.02, Porocity 0.5, Drag as the
    objective."""
    nz, ny, nx = shape
    lat = lattice_cls(model, shape, dtype=dtype,
                      settings={"nu": 0.05, "Velocity": 0.02,
                                "Porocity": 0.5, "DragInObj": 1.0}, **kw)
    flags = np.full(shape, model.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0, :] = flags[:, -1, :] = model.flag_for("Wall")
    flags[nz // 4:3 * nz // 4, ny // 4:3 * ny // 4,
          nx // 3:2 * nx // 3] |= np.uint16(model.flag_for("DesignSpace"))
    lat.set_flags(flags)
    lat.init()
    return lat


# the d2q9 family (d2q9_SRT, d2q9_les, d2q9_inc, d2q9_cumulant, d2q9_new):
# zone 1 velocity, zone 2 density (d2q9_new: zone 2 pressure), gravity
# where the model has it
FAMILY_MODELS = ("d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_cumulant",
                 "d2q9_new")
FAMILY_SHAPE = (32, 64)


def family_settings(m):
    """Settings that make every term of a family model's step count."""
    s = {"nu": 0.05, "Velocity": 0.03}
    if "GravitationX" in m.setting_index:
        s.update(GravitationX=2e-5, GravitationY=-1e-5)
    if "omega_bulk" in m.setting_index:
        s["omega_bulk"] = 0.9
    if "Smag" in m.setting_index:
        s["Smag"] = 0.16
    return s


def rich_flags_family(m, ny, nx):
    """Every node type a family model reads on a (ny, nx) field: W/E
    velocity (zone 1) and pressure (zone 2) faces, Top/BottomSymmetry rows
    where the model declares them (walls otherwise), a Wall block, a Solid
    node, a painted-but-unhandled WPressureL node, objective columns, a
    band of BGK collision nodes and, for ``d2q9_new``, overlapping
    Smagorinsky and Stab patches (there BGK nodes do not collide)."""
    f = m.flag_for
    flags = np.full((ny, nx), f("MRT"), dtype=np.uint16)
    flags[:, 0] = f("WVelocity", "MRT", zone=1)
    flags[:, -1] = f("EPressure", "MRT", zone=2)
    flags[: ny // 2, 1] = f("WPressure", "MRT", zone=2)
    flags[ny // 2:, -2] = f("EVelocity", "MRT", zone=1)
    if "TopSymmetry" in m.node_types:
        flags[0, :] = f("BottomSymmetry", "MRT")
        flags[-1, :] = f("TopSymmetry", "MRT")
    else:
        flags[0, :] = flags[-1, :] = f("Wall")
    flags[ny // 3:2 * ny // 3, nx // 8:nx // 4] = f("Wall")
    flags[ny // 3, nx // 2] = f("Solid")
    flags[ny // 2, nx // 2] = f("WPressureL", "MRT")
    flags[2:-2, 3] = f("MRT", "Inlet")
    flags[2:-2, -4] = f("MRT", "Outlet")
    flags[2:-2, nx // 2 + 4:nx // 2 + 8] = f("BGK")
    if "Stab" in m.node_types:
        flags[2:ny // 2, 5 * nx // 8:7 * nx // 8] |= np.uint16(
            f("Smagorinsky"))
        flags[ny // 4:3 * ny // 4, 3 * nx // 4:nx - 6] |= np.uint16(
            f("Stab"))
    return flags


def family_planes(m, shape, seed):
    """Populations near a flowing equilibrium plus 2% noise, in the
    model's own velocity order."""
    rng = np.random.default_rng(seed)
    E = m.ei[:9, :2].astype(np.float64)
    w = np.array([{0: 4 / 9, 1: 1 / 9, 2: 1 / 36}[int((e * e).sum())]
                  for e in E])
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.03 + 0.01 * rng.standard_normal((2,) + shape)
    planes = {}
    for k in range(9):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1]
        feq = w[k] * rho * (1 + 3 * eu + 4.5 * eu * eu
                            - 1.5 * (u * u).sum(0))
        planes[f"f[{k}]"] = feq * (1 + 0.02 * rng.standard_normal(shape))
    return planes


def paint_rich_family(lat, seed):
    """``rich_flags_family`` with zonal Velocity and Density (Pressure for
    ``d2q9_new``) and ``family_planes`` on a Lattice of either package."""
    m = lat.model
    lat.set_flags(rich_flags_family(m, *lat.shape))
    lat.set_setting("Velocity", 0.04, zone=1)
    if "Density" in m.setting_index:
        lat.set_setting("Density", 1.002, zone=2)
    else:
        lat.set_setting("Pressure", 0.0007, zone=2)
    lat.init()
    lat.set_density_planes(family_planes(m, lat.shape, seed))
    return lat


def channel_flags(m, ny, nx, coll="MRT"):
    """bench.py's 2D channel (bench.py:154-167): W velocity inlet, E
    pressure outlet, walls, a block obstacle and objective columns, over
    ``coll`` collision nodes."""
    f = m.flag_for
    flags = np.full((ny, nx), f(coll), dtype=np.uint16)
    flags[:, 0] = f("WVelocity", coll)
    flags[:, -1] = f("EPressure", coll)
    flags[0, :] = f("Wall")
    flags[-1, :] = f("Wall")
    flags[ny // 3:2 * ny // 3, nx // 10:nx // 5] = f("Wall")
    flags[1:-1, 2] = f(coll, "Inlet")
    flags[1:-1, -3] = f(coll, "Outlet")
    return flags


def cumulant_channel_flags(m, ny, nx):
    """bench.py's d2q9_cumulant channel (bench.py:194-207): BGK nodes, a
    W velocity inlet, an E pressure outlet and two walls."""
    f = m.flag_for
    flags = np.full((ny, nx), f("BGK"), dtype=np.uint16)
    flags[:, 0] = f("WVelocity", "BGK")
    flags[:, -1] = f("EPressure", "BGK")
    flags[0, :] = flags[-1, :] = f("Wall")
    return flags


def srt_poiseuille_xml(out="output/"):
    """example/poiseuille.xml (BASELINE config 2) on model d2q9_SRT, the
    XML otherwise unchanged: 40x21 nodes, walls on y, GravitationX in SI
    units, 10000 iterations with Log every 1000 and VTK every 5000."""
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "example" \
        / "poiseuille.xml"
    text = path.read_text()
    assert 'model="d2q9"' in text and 'output="output/"' in text
    return text.replace('model="d2q9"', 'model="d2q9_SRT"') \
        .replace('output="output/"', f'output="{out}"')


# the rest of the z-slab family (d3q27_BGK, d3q27_BGK_galcor, d3q19,
# d3q19_les): zone 1 velocity, zone 2 density, gravity on all three axes
D3Q_FAMILY = ("d3q27_BGK", "d3q27_BGK_galcor", "d3q19", "d3q19_les")


def d3q_family_settings(m, **extra):
    """Settings that make every term of a family model's step count
    (d3q19's ``S_high`` and d3q19_les's ``Smag`` where the model has
    them, or as ``extra`` gives them)."""
    s = {"nu": 0.05, "Velocity": 0.03, "GravitationX": 2e-5,
         "GravitationY": -1e-5, "GravitationZ": 5e-6}
    if "S_high" in m.setting_index:
        s["S_high"] = 1.3
    if "Smag" in m.setting_index:
        s["Smag"] = 0.17
    s.update(extra)
    return s


def rich_flags_d3q(m, nz, ny, nx):
    """Every node type a family model reads, painted on a (nz, ny, nx)
    field: W velocity (zone 1) and pressure (zone 2) on the x faces, E
    pressure and velocity, S/N symmetry rows, a Wall block, a Solid node,
    an unhandled WPressureL node, objective columns, BGK collision nodes
    beside the MRT ones."""
    f = m.flag_for
    flags = np.full((nz, ny, nx), f("MRT"), dtype=np.uint16)
    h = nz // 2
    flags[:, :, 0] = f("WVelocity", "MRT", zone=1)
    flags[:h, :, 1] = f("WPressure", "MRT", zone=2)
    flags[:, :, -1] = f("EPressure", "MRT", zone=2)
    flags[h:, :, -2] = f("EVelocity", "MRT", zone=1)
    flags[:, 0, 2:-2] = f("SSymmetry", "MRT")
    flags[:, -1, 2:-2] = f("NSymmetry", "MRT")
    flags[nz // 4:nz // 4 + 3, 3:5, nx // 4:nx // 4 + 4] = f("Wall")
    flags[0, ny // 2, 3 * nx // 4] = f("Solid")
    flags[h, ny // 2, nx // 2] = f("WPressureL", "MRT")
    flags[1:-1, 2:-2, 4] = f("MRT", "Inlet")
    flags[1:-1, 2:-2, -5] = f("MRT", "Outlet")
    flags[:, 2:-2, 6:9] = f("BGK")
    return flags


def d3q_planes(m, shape, seed):
    """Populations of a family model near a flowing equilibrium plus 2%
    noise, in the model's own velocity order."""
    rng = np.random.default_rng(seed)
    q = m.n_storage
    E = m.ei[:q].astype(np.float64)
    table = ({0: 1 / 3, 1: 1 / 18, 2: 1 / 36} if q == 19 else
             {0: 8 / 27, 1: 2 / 27, 2: 1 / 54, 3: 1 / 216})
    w = np.array([table[int((e * e).sum())] for e in E])
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    u[0] += 0.03
    usq = (u * u).sum(0)
    planes = {}
    for k in range(q):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1] + E[k, 2] * u[2]
        feq = w[k] * rho * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
        planes[f"f[{k}]"] = feq * (1 + 0.02 * rng.standard_normal(shape))
    return planes


def paint_rich_d3q(lat, seed):
    """``rich_flags_d3q`` with zonal Velocity and Density and
    ``d3q_planes`` on a Lattice of either package."""
    lat.set_flags(rich_flags_d3q(lat.model, *lat.shape))
    lat.set_setting("Velocity", 0.04, zone=1)
    lat.set_setting("Density", 1.002, zone=2)
    lat.init()
    lat.set_density_planes(d3q_planes(lat.model, lat.shape, seed))
    return lat


def channel3d_flags(m, nz, ny, nx):
    """bench.py's 3D channel (bench.py:619-662): MRT nodes, walls at y = 0
    and y = ny - 1 (the body force along x drives it)."""
    flags = np.full((nz, ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0, :] = m.flag_for("Wall")
    flags[:, -1, :] = m.flag_for("Wall")
    return flags


# <Control> time series.  SERIES_SETTINGS and series_flags are the d2q9
# case of tests/test_pallas_generic.py's series tests (its _SETTINGS and
# _paint); add_rich_series sets series on two zones of the rich states
# above, with a horizon shorter than the runs, so the iteration wraps.
SERIES_SETTINGS = {"nu": 0.05, "Velocity": 0.02}
RICH_SERIES_T = 5


def series_flags(m, ny, nx, objectives=False):
    """MRT nodes, walls at y = 0 and ny - 1, a W velocity and an E
    pressure face, a zone-1 stripe; with ``objectives`` the Inlet and
    Outlet columns."""
    f = m.flag_for
    flags = np.full((ny, nx), f("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[1:-1, 0] = f("WVelocity", "MRT")
    flags[1:-1, -1] = f("EPressure", "MRT")
    flags[ny // 4:ny // 2, nx // 4:nx // 2] = f("MRT", zone=1)
    if objectives:
        flags[1:-1, 2] = f("MRT", "Inlet")
        flags[1:-1, -3] = f("MRT", "Outlet")
    return flags


def series_values(T, base=0.02, amp=0.005, rate=0.7, phase=0.0):
    """``base + amp sin(rate t + phase)`` over a horizon of ``T``
    iterations."""
    return base + amp * np.sin(np.arange(T) * rate + phase)


def add_rich_series(lat, T=RICH_SERIES_T):
    """Series on two zones of a rich state of either package: the inlet
    velocity zone 1 and the density zone 2 (d2q9, d3q19_adj), or both
    Density zones of d2q9_kuper."""
    zonal = [s.name for s in lat.model.settings if s.zonal]
    if "Velocity" in zonal:
        lat.set_setting_series("Velocity", series_values(T, 0.035, 0.01),
                               zone=1)
        lat.set_setting_series("Density", series_values(
            T, 1.002, 0.002, 1.3, phase=0.5), zone=2)
    else:
        table = lat.params.zone_table
        vals = np.asarray(table.cpu() if hasattr(table, "cpu") else table)[
            lat.model.setting_index["Density"]]
        for z in (0, 1):
            lat.set_setting_series("Density", float(vals[z]) * series_values(
                T, 1.0, 0.01, 0.9 + z, phase=0.5), zone=z)
    return lat


def ramp_csv(path, rows=11, lo=0.01, hi=0.03):
    """A one-column CSV (``vel``) that ramps from ``lo`` to ``hi``."""
    with open(path, "w") as f:
        f.write("vel\n")
        for v in np.linspace(lo, hi, rows):
            f.write(f"{v:.6f}\n")
    return path


ADJ3D_CONTROL_SIZES = {
    "chip": dict(nz=32, ny=64, nx=256, solve=2000, log=500),
    "test": dict(nz=8, ny=16, nx=32, solve=40, log=10),
}


def adj3d_control_xml(csv, size="test", out="output/"):
    """The 3D adjoint case's geometry and settings (``adj3d_case_xml``)
    with a forward Solve only, its inlet zone's Velocity under a <Control>
    ramp read from ``csv`` over the Solve's horizon, and a Log."""
    s = ADJ3D_CONTROL_SIZES[size]
    nz, ny, nx = s["nz"], s["ny"], s["nx"]
    return f"""<?xml version="1.0"?>
<CLBConfig version="2.0" model="d3q19_adj" output="{out}">
    <Geometry nx="{nx}" ny="{ny}" nz="{nz}">
        <MRT><Box/></MRT>
        <WVelocity name="Inlet"><Box nx="1"/></WVelocity>
        <EPressure name="Outlet"><Box dx="-1"/></EPressure>
        <Wall mask="ALL"><Channel/></Wall>
        <DesignSpace><Box dx="{nx // 3}" nx="{nx // 3}" dy="{ny // 4}"
            ny="{ny // 2}" dz="{nz // 4}" nz="{nz // 2}"/></DesignSpace>
    </Geometry>
    <Model>
        <Params Velocity="0.02" nu="0.05"/>
        <Params Porocity="0.5" DragInObj="1"/>
    </Model>
    <Control Iterations="{s['solve']}">
        <CSV file="{csv}"/>
        <Params Velocity-Inlet="vel"/>
    </Control>
    <Log Iterations="{s['log']}"/>
    <Solve Iterations="{s['solve']}"/>
</CLBConfig>
"""


# --------------------------------------------------------------------------- #
# the one-stage 2D models on the generic kernels
# --------------------------------------------------------------------------- #

ONESTAGE_MODELS = ("d2q9_heat", "d2q9_heat_conjugate", "d2q9_hb", "sw",
                   "d2q9_solid", "d2q9_npe_guo")
ONESTAGE_SHAPE = (16, 128)     # nx a multiple of 128: the reference's call_g
# example/solidification.xml's and example/npe_guo.xml's settings
SOLID_SETTINGS = {"nu": 0.1, "FluidAlfa": 0.05, "SoluteDiffusion": 0.05,
                  "C0": 0.5, "Concentration": 0.5, "Temperature": 0.95,
                  "T0": 0.95, "Teq": 1.0, "LiquidusSlope": -1.0,
                  "PartitionCoef": 0.1, "GTCoef": 0.001,
                  "SurfaceAnisotropy": 0.02}
NPE_SETTINGS = {"n_inf_0": 0.01, "n_inf_1": 0.01, "psi_bc": -0.05,
                "psi0": 0.0, "phi0": 0.0, "phi_bc": 0.0, "el_kbT": 1.0,
                "epsilon": 1.0, "ez": 1.0, "nu": 0.1666666}
# tests/test_pallas_generic.py's _SETTINGS where it has the model, the
# example's otherwise (d2q9_hb: d2q9_heat's, with the erosion switched on;
# sw: with sw_wave.xml's Gravity, since at the default 1.0 the wave speed
# sqrt(g h) exceeds the lattice's sound speed and the painted lattice goes
# non-finite within 500 steps, in f32 and f64 alike)
GENERIC_SETTINGS = {
    "d2q9_heat": {"nu": 0.05, "InletVelocity": 0.02, "FluidAlfa": 0.05},
    "d2q9_heat_conjugate": {"nu": 0.05, "InletVelocity": 0.02,
                            "FluidAlfa": 0.05, "SolidAlfa": 0.02},
    "d2q9_hb": {"nu": 0.05, "InletVelocity": 0.02, "FluidAlfa": 0.05,
                "DestructionRate": 0.5, "DestructionPower": 1.5},
    "sw": {"nu": 0.05, "Gravity": 0.5},
    "d2q9_solid": SOLID_SETTINGS,
    "d2q9_npe_guo": NPE_SETTINGS,
}
# the rich states: every branch of each header switched on
RICH_ONESTAGE_SETTINGS = {
    **GENERIC_SETTINGS,
    "d2q9_heat": {**GENERIC_SETTINGS["d2q9_heat"], "HeaterTemperature": 1.5},
    "d2q9_heat_conjugate": {**GENERIC_SETTINGS["d2q9_heat_conjugate"],
                            "HeaterTemperature": 1.5},
    "d2q9_hb": {**GENERIC_SETTINGS["d2q9_hb"], "HeaterTemperature": 1.5},
    "sw": {"nu": 0.05, "Gravity": 0.5, "Height": 1.0, "EnergySink": 0.1,
           "InletVelocity": 0.01, "S2": 1.2, "S3": 0.9},
    "d2q9_solid": {**SOLID_SETTINGS, "Theta0": 0.3, "Buoyancy": 0.01,
                   "Velocity": 0.01},
    "d2q9_npe_guo": {**NPE_SETTINGS, "phi_bc": 0.1, "t_to_s": 1.2},
}
# zone 1's value of each zonal setting on the rich states
RICH_ONESTAGE_ZONE1 = {"HeaterTemperature": 2.0, "Height": 1.05,
                       "Velocity": 0.02, "Pressure": 0.01,
                       "Temperature": 0.9, "Concentration": 0.45,
                       "Theta0": 0.6, "rho_bc": 1.001, "phi_bc": 0.5,
                       "psi_bc": -0.04}


def paint_generic(m, ny, nx):
    """tests/test_pallas_generic.py's ``_paint``: the collision type
    inside, walls top and bottom, W velocity and E pressure faces where
    the model declares them (d2q9_npe_guo: a W pressure face, its driving
    boundary), a settings zone 1 stripe; d2q9_hb adds a Destroy stripe and
    d2q9_solid a Seed, so that their erosion and growth run."""
    f = m.flag_for
    coll = "MRT" if "MRT" in m.node_types else "BGK"
    flags = np.full((ny, nx), f(coll), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = f("Wall")
    west = "WPressure" if m.name == "d2q9_npe_guo" else "WVelocity"
    flags[1:-1, 0] = f(west, coll)
    flags[1:-1, -1] = f("EPressure", coll)
    flags[ny // 4:ny // 2, nx // 4:nx // 2] = f(coll, zone=1)
    if "Destroy" in m.node_types:
        flags[ny // 2:3 * ny // 4, nx // 2:3 * nx // 4] = f(coll, "Destroy")
    if "Seed" in m.node_types:
        flags[ny // 2 - 1:ny // 2 + 1, nx // 2 - 1:nx // 2 + 1] = \
            f(coll, "Seed")
    return flags


def rich_flags_onestage(m, ny, nx):
    """Every node type the model's device header reads on a (ny, nx) field
    (ny >= 16, nx >= 32): split W and E faces (velocity and pressure),
    walls top and bottom, a Solid block, the model's extra types in
    patches, and a settings zone 1 block."""
    f = m.flag_for
    nt = m.node_types
    coll = "MRT" if "MRT" in nt else "BGK"
    flags = np.full((ny, nx), f(coll), dtype=np.uint16)
    h = ny // 2
    for col, upper, lower in ((0, "WVelocity", "WPressure"),
                              (nx - 1, "EPressure", "EVelocity")):
        flags[h:, col] = f(upper, coll)
        flags[:h, col] = f(lower, coll)
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[h - 2:h + 1, nx // 8:nx // 8 + 3] = f("Solid")
    if "BottomSymmetry" in nt:
        flags[1, nx // 2:3 * nx // 4] = f("BottomSymmetry", coll)
        flags[-2, nx // 2:3 * nx // 4] = f("TopSymmetry", coll)
    # the extra types, one patch each along the channel
    extra = [n for n in ("Heater", "Destroy", "Obj1", "ForceTemperature",
                         "ForceConcentration", "Obj", "Outlet")
             if n in nt]
    for i, name in enumerate(extra):
        x0 = nx // 4 + i * 4
        if nt[name].group == "OBJECTIVE":
            flags[2:-2, x0:x0 + 2] |= np.uint16(f(name))
        else:
            flags[3:h, x0:x0 + 3] |= np.uint16(f(name))
    zone = np.uint16(1 << m.zone_shift)
    flags[h:-1, nx // 2:] |= zone
    return flags


def onestage_planes(m, shape, seed):
    """Populations near a flowing equilibrium with 1-2% noise in every d2q9
    group (each around its own scalar), sw's design field w in [0.1, 1],
    d2q9_solid's fi_s in [0, 1] with fully solid nodes (some at the
    periodic edges, so the Field stencil crosses them) and Cs small."""
    rng = np.random.default_rng(seed)
    E = m.ei[:9, :2].astype(np.float64)
    wt = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    u = 0.02 + 0.01 * rng.standard_normal((2,) + shape)
    usq = (u * u).sum(0)
    base = {"f": 1.0, "T": 0.7, "g": 0.95, "h": 0.5, "phi": 0.01,
            "h_0": 0.01, "h_1": 0.01}
    planes = {}
    for name, idx in m.groups.items():
        if name not in base or len(idx) != 9:
            continue
        level = base.get(name, 1.0) * (1 + 0.01 * rng.standard_normal(shape))
        for k in range(9):
            eu = E[k, 0] * u[0] + E[k, 1] * u[1]
            eq = wt[k] * level * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
            planes[m.storage_names[idx[k]]] = eq * (
                1 + 0.02 * rng.standard_normal(shape))
    if "w" in m.storage_index:
        planes["w"] = 0.1 + 0.9 * rng.random(shape)
    if "fi_s" in m.storage_index:
        fi = rng.random(shape)
        fi[fi > 0.8] = 1.0
        fi[:, 0] = fi[0, :] = 1.0
        planes["fi_s"] = fi
        planes["Cs"] = 0.05 * rng.random(shape)
    return planes


def paint_rich_onestage(lat, seed):
    """``rich_flags_onestage``, zone 1's values of the zonal settings, Init
    and ``onestage_planes`` on a Lattice of either package (settings from
    ``RICH_ONESTAGE_SETTINGS`` at its construction)."""
    m = lat.model
    lat.set_flags(rich_flags_onestage(m, *lat.shape))
    for name in m.zonal_settings:
        lat.set_setting(name, RICH_ONESTAGE_ZONE1[name], zone=1)
    lat.init()
    lat.set_density_planes(onestage_planes(m, lat.shape, seed))
    return lat


# --------------------------------------------------------------------------- #
# the multi-stage 2D models on the generic kernels
# --------------------------------------------------------------------------- #

MULTISTAGE_MODELS = ("d2q9_pf_pressureEvolution", "d2q9_pp_MCMP", "d2q9_lee",
                     "d2q9_poison_boltzmann")
MULTISTAGE_SHAPE = (16, 64)
# each model's shipped example and its lattice (ny, nx)
MULTISTAGE_EXAMPLES = {"d2q9_pf_pressureEvolution": "bubble_rise.xml",
                       "d2q9_pp_MCMP": "mcmp_contact.xml",
                       "d2q9_lee": "drop_lee.xml"}
# tests/test_pallas_generic.py's _SETTINGS where it has the model;
# bubble_rise.xml's for d2q9_pf_pressureEvolution, the JAX package's
# physics test's for d2q9_poison_boltzmann (tests/test_electrokinetics.py)
MULTISTAGE_SETTINGS = {
    "d2q9_pf_pressureEvolution": {"nu_l": 0.1, "nu_h": 0.1, "M": 0.05,
                                  "W": 4.0, "PhaseField": -0.5,
                                  "GravitationY": -1e-6, "sigma": 0.0001},
    "d2q9_pp_MCMP": {"nu": 1 / 6, "nu_g": 1 / 6, "Gc": 1.8, "Gad1": 0.0,
                     "Gad2": 0.0, "Density": 1.0, "Density_dry": 1.0},
    "d2q9_lee": {"nu": 1 / 6, "LiquidDensity": 1.0, "VaporDensity": 0.1,
                 "Beta": 0.02, "Kappa": 0.02, "InitDensity": 1.0,
                 "WallDensity": 1.0},
    "d2q9_poison_boltzmann": {"tau_psi": 1.0, "n_inf": 0.01, "psi_bc": 0.01,
                              "psi0": 0.0, "epsilon": 1.0},
}
# the rich states: every branch of each header switched on (two densities
# and forces in the phase field, a tangential inlet, a moving lid)
RICH_MULTISTAGE_SETTINGS = {
    **MULTISTAGE_SETTINGS,
    "d2q9_pf_pressureEvolution": {
        **MULTISTAGE_SETTINGS["d2q9_pf_pressureEvolution"],
        "Density_h": 1.0, "Density_l": 0.2, "nu_h": 0.05, "S1": 1.1,
        "S2": 1.2, "GravitationX": 2e-6, "BuoyancyY": 1e-6,
        "GmatchedX": 1e-6},
    "d2q9_pp_MCMP": {**MULTISTAGE_SETTINGS["d2q9_pp_MCMP"], "nu_g": 0.1,
                     "Gad1": -0.2, "Gad2": 0.1, "GravitationY": -1e-6},
    "d2q9_lee": {**MULTISTAGE_SETTINGS["d2q9_lee"], "GravitationY": -1e-6,
                 "MovingWallVelocity": 0.01, "InletVelocity": 0.01,
                 "WetDensity": 0.97, "DryDensity": 0.93,
                 "OutletDensity": 0.99, "InletDensity": 1.01},
    "d2q9_poison_boltzmann": {**MULTISTAGE_SETTINGS["d2q9_poison_boltzmann"],
                              "tau_psi": 0.8, "n_inf": 0.05, "z": 2.0},
}
# zone 1's value of each zonal setting on the rich states
RICH_MULTISTAGE_ZONE1 = {
    "PhaseField": 0.5, "VelocityX": 0.0, "VelocityY": 0.0, "Pressure": 0.0,
    "Velocity_f": 0.01, "Pressure_f": 0.01, "Velocity_g": 0.005,
    "Pressure_g": 0.005, "Density": 1.0, "Density_dry": 1.0,
    "InletVelocity": 0.02, "InletPressure": 0.0, "InletDensity": 1.005,
    "OutletDensity": 0.995, "InitDensity": 0.95, "WallDensity": 0.96,
    "MovingWallVelocity": 0.02, "WetDensity": 0.98, "DryDensity": 0.94,
    "Wetting": 1.0, "psi_bc": 0.08, "psi0": 0.01}


def rich_flags_multistage(m, ny, nx):
    """Every node type the model's device header reads on a (ny, nx) field
    (ny >= 16, nx >= 64): the collision types inside (lee: BGK and MRT
    halves), walls top and bottom, a Solid block, split W and E faces
    where the model has Zou/He faces, lee's moving lids and Wet/Dry
    patches, and a settings zone 1 block."""
    f = m.flag_for
    nt = m.node_types
    coll = "MRT" if m.name == "d2q9_pf_pressureEvolution" else "BGK"
    flags = np.full((ny, nx), f(coll), dtype=np.uint16)
    if m.name == "d2q9_lee":
        flags[:, nx // 2:] = f("MRT")
    h = ny // 2
    if m.name in ("d2q9_pp_MCMP", "d2q9_lee"):
        for col, upper, lower in ((0, "WVelocity", "WPressure"),
                                  (nx - 1, "EPressure", "EVelocity")):
            flags[h:, col] = f(upper, coll)
            flags[:h, col] = f(lower, coll)
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[h - 2:h + 1, nx // 8:nx // 8 + 3] = f("Solid")
    if m.name == "d2q9_lee":
        flags[1, nx // 4:nx // 4 + 6] = f("MovingWall")
        flags[1, nx // 2 + 4:nx // 2 + 10] = f("ForcedMovingWall", "MRT")
        flags[0, 3 * nx // 4:] |= np.uint16(f("Wet"))
        flags[-1, 3 * nx // 4:] |= np.uint16(f("Dry"))
        flags[h:, 0] |= np.uint16(f("Wet"))
        flags[3:6, 3 * nx // 8:3 * nx // 8 + 3] |= np.uint16(f("Dry"))
    flags[h:-1, nx // 2:] |= np.uint16(1 << m.zone_shift)
    return flags


def multistage_planes(m, shape, seed):
    """Populations near a flowing equilibrium with 1-2% noise in every d2q9
    group (each around its own level), and each Field near what its stage
    would write: PhaseF a smooth drop in [0, 1], psi_f and psi_g near the
    component densities, lee's rho across the two phases and nu small,
    the Poisson potential small; subiter a count."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    E = m.ei[:9, :2].astype(np.float64)
    wt = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    u = 0.01 + 0.005 * rng.standard_normal((2,) + shape)
    usq = (u * u).sum(0)
    y, x = np.mgrid[0:ny, 0:nx]
    drop = 0.5 + 0.5 * np.tanh((ny / 3 - np.hypot(x - nx / 2, y - ny / 2))
                               / 2.0)
    level = {"d2q9_pf_pressureEvolution": {"f": 0.0, "h": drop},
             "d2q9_pp_MCMP": {"f": 0.3 + 0.7 * drop, "g": 1.0 - 0.7 * drop},
             "d2q9_lee": {"f": 0.9 + 0.1 * drop},
             "d2q9_poison_boltzmann": {}}[m.name]
    planes = {}
    for name, base in level.items():
        idx = m.groups[name]
        lev = base * (1 + 0.01 * rng.standard_normal(shape))
        for k in range(9):
            eu = E[k, 0] * u[0] + E[k, 1] * u[1]
            eq = wt[k] * lev * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
            noise = 0.02 * rng.standard_normal(shape)
            # the pressure-shifted g-bar sits near 0: absolute noise
            shifted = m.name == "d2q9_pf_pressureEvolution" and name == "f"
            planes[m.storage_names[idx[k]]] = (1e-3 * wt[k] * noise
                                               if shifted else eq * (1 + noise))
    if m.name == "d2q9_pf_pressureEvolution":
        planes["PhaseF"] = drop + 0.01 * rng.standard_normal(shape)
    if m.name == "d2q9_pp_MCMP":
        for name, grp in (("psi_f", "f"), ("psi_g", "g")):
            planes[name] = level[grp] * (1 + 0.01 * rng.standard_normal(
                shape))
    if m.name == "d2q9_lee":
        planes["rho"] = level["f"] * (1 + 0.01 * rng.standard_normal(shape))
        planes["nu"] = 1e-3 * rng.standard_normal(shape)
    if m.name == "d2q9_poison_boltzmann":
        pot = 0.02 * rng.standard_normal(shape)
        wp = np.array([1 / 9 - 1] + [1 / 9] * 8)
        for k in range(9):
            planes[f"g[{k}]"] = wp[k] * pot + 1e-3 * rng.standard_normal(
                shape)
        planes["psi"] = pot
        planes["subiter"] = np.full(shape, 3.0)
    return planes


def paint_rich_multistage(lat, seed):
    """``rich_flags_multistage``, zone 1's values of the zonal settings,
    Init and ``multistage_planes`` on a Lattice of either package
    (settings from ``RICH_MULTISTAGE_SETTINGS`` at its construction)."""
    m = lat.model
    lat.set_flags(rich_flags_multistage(m, *lat.shape))
    for name in m.zonal_settings:
        lat.set_setting(name, RICH_MULTISTAGE_ZONE1[name], zone=1)
    lat.init()
    lat.set_density_planes(multistage_planes(m, lat.shape, seed))
    return lat


# --------------------------------------------------------------------------- #
# the 2D adjoint models on the generic kernels
# --------------------------------------------------------------------------- #

ADJ_MODELS = ("d2q9_adj", "d2q9_optimalMixing", "d2q9_plate")
ADJ_SHAPE = (16, 64)
# tests/test_pallas_adjoint.py:_setup's settings for d2q9_adj (bench.py's
# and example/adj_drag.xml's flow); a mixing and a plate flow alike
ADJ_SETTINGS = {
    "d2q9_adj": {"nu": 0.1, "Velocity": 0.05, "Porocity": 0.5,
                 "DragInObj": 1.0},
    "d2q9_optimalMixing": {"nu": 0.05, "K": 0.1, "Temperature": 1.0,
                           "MovingWallVelocity": 0.03,
                           "TotalTempSqrInObj": 1.0},
    "d2q9_plate": {"nu": 0.05, "Velocity": 0.02, "Smag": 0.16,
                   "ForceXInObj": 1.0},
}
# the rich states: every branch of each header switched on (the porosity
# transform, the body forces, a moving wall)
RICH_ADJ_SETTINGS = {
    "d2q9_adj": {**ADJ_SETTINGS["d2q9_adj"], "PorocityTheta": -1.0,
                 "ForceX": 1e-5, "ForceY": -2e-6},
    "d2q9_optimalMixing": ADJ_SETTINGS["d2q9_optimalMixing"],
    "d2q9_plate": {**ADJ_SETTINGS["d2q9_plate"], "GravitationX": 1e-5,
                   "GravitationY": -2e-6},
}
# zone 1's value of each zonal setting on the rich states
RICH_ADJ_ZONE1 = {"Velocity": 0.03, "Pressure": 0.01, "Porocity": 0.3,
                  "MovingWallVelocity": 0.05, "Temperature": 0.5,
                  "Density": 1.01}
# a zonal setting of each model under a <Control> series on zone 0
ADJ_SERIES = {"d2q9_adj": ("Velocity", [0.05, 0.04, 0.06, 0.045, 0.055]),
              "d2q9_optimalMixing": ("MovingWallVelocity",
                                     [0.03, 0.05, 0.01, 0.04, 0.02]),
              "d2q9_plate": ("Velocity", [0.02, 0.025, 0.015, 0.03, 0.01])}


def rich_flags_adj(m, ny, nx):
    """Every node type the model's device header reads on a (ny, nx) field
    (ny >= 16, nx >= 32): split W and E faces (velocity and pressure),
    walls top and bottom, a Solid block, a BGK patch among the MRT nodes,
    MovingWall segments with and without collision where the model has the
    type, Inlet and Outlet columns, a DesignSpace block and a settings
    zone 1 block that cuts across them."""
    f = m.flag_for
    nt = m.node_types
    flags = np.full((ny, nx), f("MRT"), dtype=np.uint16)
    h = ny // 2
    for col, upper, lower in ((0, "WVelocity", "WPressure"),
                              (nx - 1, "EPressure", "EVelocity")):
        flags[h:, col] = f(upper, "MRT")
        flags[:h, col] = f(lower, "MRT")
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[h - 2:h + 1, nx // 8:nx // 8 + 3] = f("Solid")
    flags[h + 2:h + 4, nx // 8:nx // 8 + 3] = f("BGK")
    if "MovingWall" in nt:
        flags[-1, nx // 4:nx // 2] = f("MovingWall")
        flags[1, nx // 4:nx // 2] = f("MovingWall", "MRT")
    flags[2:-2, 3] |= np.uint16(f("Inlet"))
    flags[2:-2, nx - 4] |= np.uint16(f("Outlet"))
    flags[3:h + 3, nx // 2 - 6:nx // 2 + 4] |= np.uint16(f("DesignSpace"))
    flags[h:, nx // 2:] |= np.uint16(1 << m.zone_shift)
    return flags


def adj_planes(m, shape, seed):
    """Populations near a flowing equilibrium with 1-2% noise (d2q5's g
    around a temperature of 0.7), and the design field w in [0.1, 1]."""
    rng = np.random.default_rng(seed)
    E = m.ei[:9, :2].astype(np.float64)
    wt = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    u = 0.02 + 0.01 * rng.standard_normal((2,) + shape)
    usq = (u * u).sum(0)
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    planes = {}
    for k in range(9):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1]
        eq = wt[k] * rho * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
        planes[f"f[{k}]"] = eq * (1 + 0.02 * rng.standard_normal(shape))
    if "g" in m.groups:
        idx = m.groups["g"]
        eg = m.ei[list(idx), :2].astype(np.float64)
        wg = np.array([1 / 3] + [1 / 6] * 4)
        temp = 0.7 * (1 + 0.01 * rng.standard_normal(shape))
        for j, i in enumerate(idx):
            eu = eg[j, 0] * u[0] + eg[j, 1] * u[1]
            planes[m.storage_names[i]] = wg[j] * temp * (1 + 3 * eu) * (
                1 + 0.02 * rng.standard_normal(shape))
    if "w" in m.storage_index:
        planes["w"] = 0.1 + 0.9 * rng.random(shape)
    return planes


def paint_rich_adj(lat, seed):
    """``rich_flags_adj``, zone 1's values of the zonal settings, Init and
    ``adj_planes`` on a Lattice of either package (settings from
    ``RICH_ADJ_SETTINGS`` at its construction)."""
    m = lat.model
    lat.set_flags(rich_flags_adj(m, *lat.shape))
    for name in m.zonal_settings:
        lat.set_setting(name, RICH_ADJ_ZONE1[name], zone=1)
    lat.init()
    lat.set_density_planes(adj_planes(m, lat.shape, seed))
    return lat


def adj_channel(lattice_cls, model, dtype, shape=(16, 128),
                design=(slice(4, 12), slice(40, 80)), **kw):
    """tests/test_pallas_adjoint.py:_setup's d2q9_adj channel (bench.py's
    ``bench_adjoint`` at 512x1024 with the design block ``[128:384,
    300:700]``) on a Lattice of either package: a W velocity inlet, an E
    pressure outlet, walls top and bottom and a DesignSpace block."""
    ny, nx = shape
    lat = lattice_cls(model, shape, dtype=dtype,
                      settings=ADJ_SETTINGS["d2q9_adj"], **kw)
    flags = np.full(shape, model.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = model.flag_for("WVelocity", "MRT")
    flags[:, -1] = model.flag_for("EPressure", "MRT")
    flags[0, :] = flags[-1, :] = model.flag_for("Wall")
    flags[design] |= np.uint16(model.flag_for("DesignSpace"))
    lat.set_flags(flags)
    lat.init()
    return lat


# The 3D models of the generic engine (K6): tests/test_pallas_generic.py's
# _3D_SETTINGS where it names the model, a few more settings so every term
# counts (gravity, a yield stress between the noise's S:S, a force), and
# zone 1's own zonal values
GENERIC3D_MODELS = ("d3q19_heat", "d3q27", "d3q27_viscoplastic",
                    "d3q27_cumulant_qibb_small", "d3q19_kuper")
GENERIC3D_SHAPE = (6, 16, 32)
GENERIC3D_SETTINGS = {
    "d3q19_heat": {"nu": 0.05, "Velocity": 0.02, "FluidAlfa": 0.05},
    "d3q27": {},
    "d3q27_viscoplastic": {"nu": 0.1},
    "d3q27_cumulant_qibb_small": {},
    "d3q19_kuper": {"nu": 0.1, "Temperature": 0.9, "Magic": 0.01},
}
RICH_GENERIC3D_SETTINGS = {
    "d3q19_heat": {**GENERIC3D_SETTINGS["d3q19_heat"],
                   "GravitationX": 1e-5, "S_high": 1.2,
                   "InletTemperature": 1.5, "HeaterTemperature": 3.0},
    "d3q27": {"nu": 0.05, "Velocity": 0.02, "GravitationX": 1e-5,
              "GravitationZ": -2e-6, "omega_bulk": 1.1},
    "d3q27_viscoplastic": {"nu": 0.1, "YieldStress": 5e-4, "ForceX": 1e-5,
                           "ForceY": -3e-6, "Velocity": 0.01,
                           "Pressure": 0.001},
    "d3q27_cumulant_qibb_small": {"nu": 0.01, "Velocity": 0.02,
                                  "ForceX": 1e-5, "GravitationY": 2e-6,
                                  "omega_bulk": 1.1, "nubuffer": 0.05},
    "d3q19_kuper": {**GENERIC3D_SETTINGS["d3q19_kuper"], "Density": 2.0,
                    "GravitationZ": -1e-5},
}
RICH_GENERIC3D_ZONE1 = {"Velocity": 0.035, "Density": 1.004,
                        "Pressure": 0.002}
KUPER3D_ZONE1_DENSITY = 1.5


def generic3d_coll(m) -> str:
    return "MRT" if "MRT" in m.node_types else "BGK"


def rich_flags_generic3d(m, node_types, nz, ny, nx):
    """Every node type in ``node_types`` (the ones the model's device
    header reads) on a (nz, ny, nx) field, as ``ops/generic2d_parity.py``
    paints a 2D header's: the collision type inside, each boundary type in
    an x column of its own, each other type in a patch (set within its
    group's bits), walls at y = 0 and y = ny - 1, zone 1 on the upper half
    in z."""
    nt = m.node_types
    coll = generic3d_coll(m)
    flags = np.full((nz, ny, nx), m.flag_for(coll), dtype=np.uint16)
    names = [n for n in node_types if n in nt and n != coll]
    step = max(nx // (len(names) + 2), 1)
    for i, name in enumerate(names):
        x = 1 + i * step
        if nt[name].group == "BOUNDARY":
            flags[:, 1:-1, x] = m.flag_for(name, coll)
        else:
            patch = flags[1:-1, ny // 4:3 * ny // 4, x:x + 2]
            patch &= np.uint16(~nt[name].mask & 0xffff)
            patch |= np.uint16(nt[name].value)
    flags[:, 0, :] = flags[:, -1, :] = m.flag_for("Wall")
    flags[nz // 2:] |= np.uint16(1 << m.zone_shift)
    return flags


def generic3d_planes(m, shape, seed):
    """The populations near a flowing equilibrium with 2% noise (d3q19,
    d3q27; d3q19_heat's d3q7 temperature around 1.2), and the other planes:
    kuper's phi around 0.6 with 10% noise, viscoplastic's nu_app and
    yield_stat at random; qibb's cut distances stay as painted."""
    rng = np.random.default_rng(seed)
    names = m.storage_names
    nf = len(m.groups["f"])
    E = m.ei[:nf].astype(np.float64)
    shell = {19: {0: 1 / 3, 1: 1 / 18, 2: 1 / 36},
             27: {0: 8 / 27, 1: 2 / 27, 2: 1 / 54, 3: 1 / 216}}[nf]
    w = np.array([shell[int((e * e).sum())] for e in E])
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.01 * rng.standard_normal((3,) + shape)
    u[0] += 0.02
    usq = (u * u).sum(0)
    planes = {}
    for k in range(nf):
        eu = E[k, 0] * u[0] + E[k, 1] * u[1] + E[k, 2] * u[2]
        feq = w[k] * rho * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
        planes[names[k]] = feq * (1 + 0.02 * rng.standard_normal(shape))
    if "T" in m.groups:
        idx = m.groups["T"]
        et = m.ei[list(idx)].astype(np.float64)
        temp = 1.2 * (1 + 0.02 * rng.standard_normal(shape))
        for j, i in enumerate(idx):
            eu = et[j, 0] * u[0] + et[j, 1] * u[1] + et[j, 2] * u[2]
            wt = 0.25 if j == 0 else 0.125
            planes[names[i]] = wt * temp * (1 + 4 * eu) * (
                1 + 0.02 * rng.standard_normal(shape))
    if "phi" in m.storage_index:
        planes["phi"] = 0.6 * (1 + 0.1 * rng.standard_normal(shape))
    if "nu_app" in m.storage_index:
        planes["nu_app"] = 0.1 * rng.random(shape)
        planes["yield_stat"] = (rng.random(shape) < 0.5).astype(np.float64)
    return planes


def qibb_cuts(shape):
    """The cut distances of a solid sphere (radius a quarter of the
    smaller cross-section, centred in the lattice), as
    ``utils.geometry.cuts_from_sdf`` paints them (26 planes)."""
    from tclb_tpu_torch.models.d3q27_cumulant_qibb import E
    from tclb_tpu_torch.utils.geometry import cuts_from_sdf, sphere_sdf
    nz, ny, nx = shape
    sdf = sphere_sdf((nz / 2 - 0.3, ny / 2 + 0.2, nx / 2 - 0.1),
                     min(nz, ny) / 4 + 0.37)
    return cuts_from_sdf(sdf, shape, E)


def qibb_flags(m, flags, cuts):
    """QIBB on every node with a cut link (set within its group's bits)."""
    has_cut = (cuts >= 0).any(axis=0)
    flags = flags.copy()
    t = m.node_types["QIBB"]
    flags[has_cut] = (flags[has_cut] & np.uint16(~t.mask & 0xffff)) \
        | np.uint16(t.value)
    return flags


def paint_rich_generic3d(lat, node_types, seed):
    """``rich_flags_generic3d`` (qibb: QIBB on the nodes a sphere's cuts
    touch), zone 1's zonal values, Init and ``generic3d_planes`` (qibb:
    the sphere's cut distances) on a Lattice of either package."""
    m = lat.model
    flags = rich_flags_generic3d(m, node_types, *lat.shape)
    cuts = None
    if "q" in m.groups:
        cuts = qibb_cuts(lat.shape)
        flags = qibb_flags(m, flags, cuts)
    lat.set_flags(flags)
    for name in m.zonal_settings:
        value = (KUPER3D_ZONE1_DENSITY if m.name == "d3q19_kuper"
                 else RICH_GENERIC3D_ZONE1[name])
        lat.set_setting(name, value, zone=1)
    lat.init()
    planes = generic3d_planes(m, lat.shape, seed)
    if cuts is not None:
        planes.update({f"q[{i + 1}]": cuts[i] for i in range(26)})
    lat.set_density_planes(planes)
    return lat


def parity3d_flags(m, shape):
    """tests/test_pallas_generic.py:_parity_3d's painting: the collision
    type with Wall rows at y = 0 and y = ny - 1."""
    flags = np.full(shape, m.flag_for(generic3d_coll(m)), dtype=np.uint16)
    flags[:, 0, :] = flags[:, -1, :] = m.flag_for("Wall")
    return flags


# --------------------------------------------------------------------------- #
# the six 2D models of the phase-field, pseudopotential and design
# workflows on the generic kernels
# --------------------------------------------------------------------------- #

MODELS2D = ("wave", "wave2d", "d2q9_diff", "d2q9_pf", "d2q9_pp_LBL",
            "d2q9_pf_curvature")
MODELS2D_SHAPE = (16, 128)     # nx a multiple of 128: the reference's call_g
# the reference's own settings: tests/test_pallas_generic.py:_SETTINGS
# where it names the model (d2q9_pf, d2q9_pp_LBL; d2q9_pf with
# tests/test_pf.py's mobility, width and phase, without which the default
# phase of 1 sharpens outside the [-0.5, 0.5] profile and a long run
# diverges), else the model's case in tests/test_models.py (wave, wave2d,
# d2q9_diff) or tests/test_pf.py (d2q9_pf_curvature's wall-sentinel case)
MODELS2D_SETTINGS = {
    "wave": {"Speed": 0.2},
    "wave2d": {"WaveK": 0.1, "Loss": 1.0, "SolidH": 1.0},
    "d2q9_diff": {"Diffusivity": 0.1, "UX": 0.02, "Source": 0.01,
                  "TotalCInObj": 1.0},
    "d2q9_pf": {"nu": 0.1, "Velocity": 0.01, "M": 0.05, "W": 0.5,
                "PhaseField": -0.5},
    "d2q9_pp_LBL": {"nu": 1 / 6, "Density": 0.5, "T": 0.35},
    "d2q9_pf_curvature": {"nu": 0.1, "omega_l": 1.0, "M": 0.05, "W": 0.5,
                          "PhaseField": -0.5, "SurfaceTensionRate": 0.05},
}
# the rich states: every term of each header switched on (damping, a
# cross flow, gravity, two relaxation rates)
RICH_MODELS2D_SETTINGS = {
    "wave": {"Speed": 0.2, "Viscosity": 0.01},
    "wave2d": {"WaveK": 0.1, "Loss": 0.995, "SolidH": 1.0,
               "TotalDiffInObj": 1.0},
    "d2q9_diff": {**MODELS2D_SETTINGS["d2q9_diff"], "UY": -0.01,
                  "InitC": 1.0, "OutCInObj": 0.5},
    "d2q9_pf": {"nu": 0.1, "Velocity": 0.01, "M": 0.05, "W": 0.5,
                "PhaseField": -0.5, "GravitationX": 1e-5,
                "GravitationY": -2e-5},
    "d2q9_pp_LBL": {**MODELS2D_SETTINGS["d2q9_pp_LBL"], "tempomega": 0.9,
                    "GravitationY": -1e-6, "GravitationX": 2e-6},
    "d2q9_pf_curvature": {**MODELS2D_SETTINGS["d2q9_pf_curvature"],
                          "omega_l": 0.8, "GravitationY": -1e-5,
                          "GravitationY_l": -2e-5, "GravitationX_l": 1e-5},
}
# zone 1's value of each zonal setting on the rich states
RICH_MODELS2D_ZONE1 = {"Value": 1.0, "InitC": 0.5, "Velocity": 0.02,
                       "Pressure": 0.01, "PhaseField": 0.5,
                       "VelocityY": 0.005, "Density": 0.52,
                       "WettingAngle": 0.0}
# the model's collision type on a painted lattice
MODELS2D_COLL = {"wave": None, "wave2d": None, "d2q9_diff": "BGK",
                 "d2q9_pf": "MRT", "d2q9_pp_LBL": "MRT",
                 "d2q9_pf_curvature": "MRT"}


def rich_flags_models2d(m, ny, nx):
    """Every node type the model's header reads on a (ny, nx) field (ny >=
    16, nx >= 64): the collision type inside, walls top and bottom, a Solid
    block, split W and E faces where the model has Zou/He faces, its
    symmetry rows, Obj1, Outlet and DesignSpace patches, wave's Dirichlet
    row and patch, and a settings zone 1 block."""
    f = m.flag_for
    nt = m.node_types
    coll = MODELS2D_COLL[m.name]
    flags = np.full((ny, nx), f(coll) if coll else 0, dtype=np.uint16)
    h = ny // 2
    if m.name == "wave":
        flags[0, :] = f("Dirichlet", zone=1)
        flags[h - 2:h + 1, nx // 8:nx // 8 + 3] = f("Dirichlet")
        flags[h:-1, nx // 2:] |= np.uint16(1 << m.zone_shift)
        return flags
    if m.name in ("d2q9_pf", "d2q9_pp_LBL", "d2q9_pf_curvature"):
        for col, upper, lower in ((0, "WVelocity", "WPressure"),
                                  (nx - 1, "EPressure", "EVelocity")):
            flags[h:, col] = f(upper, coll)
            flags[:h, col] = f(lower, coll)
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[h - 2:h + 1, nx // 8:nx // 8 + 3] = f("Solid")
    for low, high in (("BottomSymmetry", "TopSymmetry"),
                      ("SSymmetry", "NSymmetry")):
        if low in nt:
            flags[1, nx // 2:3 * nx // 4] = f(low, coll)
            flags[-2, nx // 2:3 * nx // 4] = f(high, coll)
    if "Obj1" in nt:
        flags[2:-2, nx // 4:nx // 4 + 4] |= np.uint16(f("Obj1"))
    if m.name == "d2q9_diff":
        flags[2:-2, nx - 4] |= np.uint16(f("Outlet"))
        flags[3:h + 3, nx // 2 - 6:nx // 2 + 4] |= np.uint16(
            f("DesignSpace"))
    flags[h:-1, nx // 2:] |= np.uint16(1 << m.zone_shift)
    return flags


def drop_profile(shape, radius, width=0.5, center=None):
    """The phase field of a drop: +0.5 inside, -0.5 outside, a tanh
    interface of ``width`` (tests/test_pf.py's profile)."""
    ny, nx = shape
    cy, cx = center or (ny / 2, nx / 2)
    y, x = np.mgrid[0:ny, 0:nx]
    r = np.hypot(x - cx, y - cy)
    return -np.tanh(2.0 * (r - radius) * width) / 2.0


def models2d_planes(m, flags, seed):
    """Each model's planes near what its steps produce, with noise: wave's
    Fields small, wave2d's height with four copies near it and the design
    w in [0.1, 1]; d2q9_diff's concentration near 1 at the advection
    velocity and w in [0.1, 1]; the flowing f of the phase-field and
    pseudopotential models near rho 1 (0.5 for LBL) with 2% noise, h
    around a drop, psi near 0.5, and phi near the drop with the -999
    sentinel on the walls (what CalcPhi writes there)."""
    shape = flags.shape
    rng = np.random.default_rng(seed)
    E = np.array([(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1),
                  (-1, 1), (-1, -1), (1, -1)], dtype=np.float64)
    wt = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)

    def group(level, u, noise=0.02):
        usq = (u * u).sum(0)
        out = []
        for k in range(9):
            eu = E[k, 0] * u[0] + E[k, 1] * u[1]
            eq = wt[k] * level * (1 + 3 * eu + 4.5 * eu * eu - 1.5 * usq)
            out.append(eq + noise * wt[k] * rng.standard_normal(shape))
        return out

    planes = {}
    if m.name == "wave":
        planes["u"] = 0.1 * rng.standard_normal(shape)
        planes["v"] = 0.01 * rng.standard_normal(shape)
        return planes
    if m.name == "wave2d":
        hh = 0.1 * rng.standard_normal(shape)
        planes.update(h=hh, u=0.01 * rng.standard_normal(shape),
                      w=0.1 + 0.9 * rng.random(shape))
        for k in range(1, 5):
            planes[f"h{k}"] = hh + 0.01 * rng.standard_normal(shape)
        return planes
    u = 0.01 + 0.005 * rng.standard_normal((2,) + shape)
    if m.name == "d2q9_diff":
        c = 1.0 + 0.1 * rng.standard_normal(shape)
        for k, v in enumerate(group(c, u)):
            planes[f"f[{k}]"] = v
        planes["w"] = 0.1 + 0.9 * rng.random(shape)
        return planes
    rho = (0.5 if m.name == "d2q9_pp_LBL" else 1.0) * (
        1 + 0.01 * rng.standard_normal(shape))
    for k, v in enumerate(group(rho, u)):
        planes[f"f[{k}]"] = v
    if "h" in m.groups:
        pf = drop_profile(shape, shape[0] / 3) \
            + 0.01 * rng.standard_normal(shape)
        for k, v in enumerate(group(pf, u)):
            planes[f"h[{k}]"] = v
    if m.name == "d2q9_pp_LBL":
        planes["psi"] = 0.5 * (1 + 0.02 * rng.standard_normal(shape))
    if m.name == "d2q9_pf_curvature":
        phi = drop_profile(shape, shape[0] / 3) \
            + 0.01 * rng.standard_normal(shape)
        wall = (flags.astype(np.int64) & m.node_types["Wall"].mask) \
            == m.node_types["Wall"].value
        planes["phi"] = np.where(wall, -999.0, phi)
    return planes


def paint_rich_models2d(lat, seed):
    """``rich_flags_models2d``, zone 1's values of the zonal settings, Init
    and ``models2d_planes`` on a Lattice of either package (settings from
    ``RICH_MODELS2D_SETTINGS`` at its construction)."""
    m = lat.model
    flags = rich_flags_models2d(m, *lat.shape)
    lat.set_flags(flags)
    for name in m.zonal_settings:
        lat.set_setting(name, RICH_MODELS2D_ZONE1[name], zone=1)
    lat.init()
    lat.set_density_planes(models2d_planes(m, flags, seed))
    return lat


# the 3D heat design family (d3q19_heat_adj, _art, _prop): every node type
# the header reads, two zones (zone 1 a faster inlet and a lower Porocity,
# zone 2 a denser outlet), both diffusivities, an inlet temperature above
# the initial one and every global in the objective, so every term of the
# step and its reverse counts; _prop with its propagation on
HEAT3D_MODELS = ("d3q19_heat_adj", "d3q19_heat_adj_art",
                 "d3q19_heat_adj_prop")
HEAT3D_SHAPE = (8, 16, 32)     # nz, ny, nx
HEAT3D_SETTINGS = {"nu": 0.05, "Velocity": 0.02, "FluidAlfa": 0.08,
                   "SolidAlfa": 0.02, "InletTemperature": 1.3,
                   "InitTemperature": 0.9, "HeatFluxInObj": 1.0,
                   "MaterialInObj": 0.3, "DragInObj": 0.7,
                   "PressureLossInObj": 0.2, "OutletFluxInObj": 0.3,
                   "InletFluxInObj": 0.4, "PropagateX": 0.6,
                   "MaterialPenaltyInObj": 0.4}


def heat3d_settings(m, **extra):
    """``HEAT3D_SETTINGS`` (and ``extra``) that ``m`` has."""
    return {k: v for k, v in {**HEAT3D_SETTINGS, **extra}.items()
            if k in m.setting_index}


def rich_flags_heat3d(m, nz, ny, nx):
    """Every node type the 3D heat design family reads on a (nz, ny, nx)
    field: W velocity and pressure, E pressure and velocity, S and N
    symmetry, walls, a solid node, BGK and MRT collision, an Outlet
    column, a DesignSpace block half in Porocity zone 1, and for _prop
    Propagate on the inner nodes."""
    f = m.flag_for
    flags = np.full((nz, ny, nx), f("MRT"), dtype=np.uint16)
    h = nz // 2
    flags[:h, :, 0] = f("WVelocity", "MRT", zone=1)
    flags[h:, :, 0] = f("WPressure", "MRT", zone=2)
    flags[:h, :, -1] = f("EPressure", "MRT", zone=2)
    flags[h:, :, -1] = f("EVelocity", "MRT", zone=1)
    flags[:, 0, 1:-1] = f("SSymmetry", "MRT")
    flags[:, -1, 1:-1] = f("NSymmetry", "MRT")
    flags[2:4, 5:8, 6:9] = f("Wall")
    flags[h, ny // 2, 3 * nx // 4] = f("Solid")
    flags[:, 2:-2, 3:5] = f("BGK")
    flags[1:-1, 1:-1, -3] = f("MRT", "Outlet")
    x0, x1 = nx // 3, 2 * nx // 3
    flags[1:-1, 2:-2, x0:x1] = f("MRT", "DesignSpace")
    flags[1:-1, 2:-2, x0:(x0 + x1) // 2] = f("MRT", "DesignSpace", zone=1)
    if "Propagate" in m.node_types:
        flags[:, 1:-1, 2:-2] |= np.uint16(f("Propagate"))
    return flags


def heat3d_planes(m, shape, seed):
    """d3q19 populations near a flowing equilibrium with 2% noise, the
    temperature near 1 with noise, and the design w in (0.1, 0.9) with
    every fifth node at 1 and every seventh at 0 (the clip's bounds); for
    _prop w0 in [0, 1) and w1 in (0.2, 1] with every third node at 1 (so
    that x = w exactly on a Propagate node)."""
    planes = adj3d_planes(m, shape, seed)
    rng = np.random.default_rng(seed + 100)
    t = 1.0 + 0.1 * rng.standard_normal(shape)
    wt = [0.25] + [0.125] * 6
    for k in range(7):
        planes[f"T[{k}]"] = wt[k] * t * (1 + 0.02 * rng.standard_normal(shape))
    w = planes["w"]
    w.reshape(-1)[::5] = 1.0
    w.reshape(-1)[::7] = 0.0
    if "w0" in m.storage_index:
        w1 = 0.2 + 0.8 * rng.random(shape)
        w1.reshape(-1)[::3] = 1.0
        planes.update(w0=rng.random(shape), w1=w1)
    return planes


def paint_rich_heat3d(lat, seed):
    """``rich_flags_heat3d`` with its zones and ``heat3d_planes`` on a
    Lattice of either package."""
    lat.set_flags(rich_flags_heat3d(lat.model, *lat.shape))
    lat.set_setting("Velocity", 0.03, zone=1)
    lat.set_setting("Porocity", 0.2, zone=1)
    lat.set_setting("Density", 1.002, zone=2)
    lat.init()
    lat.set_density_planes(heat3d_planes(lat.model, lat.shape, seed))
    return lat


def heat3d_design_lattice(lattice_cls, model, dtype, shape=(32, 64, 256),
                          **kw):
    """A heat design channel for the family at ``shape``: bench.py's 3D
    adjoint geometry (MRT, walls on y, periodic z, the DesignSpace block:
    the middle half in y and z, the middle third in x) with a W velocity
    inlet at InletTemperature 1 into fluid at InitTemperature 0, an E
    pressure outlet and an Outlet column before it, Porocity 0.5 in the
    block (zone 1), HeatFlux and Material in the objective; _prop with
    Propagate on the block's nodes and PropagateX 0.25: along the block
    the weight tends to (w - PropagateX) / (1 - PropagateX) = 1/3, inside
    the clip's bounds.  (A chain whose limit is a bound, as PropagateX
    0.5 gives w = 0.5, or fluid at w = 1 downstream, reaches the bound by
    rounding in f32 many columns before f64 does, and the two gradients
    part where the clip's derivative drops to 0.5.)  Initialised."""
    nz, ny, nx = shape
    lat = lattice_cls(model, shape, dtype=dtype,
                      settings=heat3d_settings(
                          model, HeatFluxInObj=1.0, MaterialInObj=0.1,
                          DragInObj=0.0, PressureLossInObj=0.0,
                          OutletFluxInObj=0.0, InletFluxInObj=0.0,
                          MaterialPenaltyInObj=0.0, PropagateX=0.25,
                          InletTemperature=1.0, InitTemperature=0.0,
                          FluidAlfa=0.05, SolidAlfa=0.01), **kw)
    f = model.flag_for
    prop = ("Propagate",) if "Propagate" in model.node_types else ()
    flags = np.full(shape, f("MRT"), dtype=np.uint16)
    flags[:, :, 0] = f("WVelocity", "MRT")
    flags[:, :, -1] = f("EPressure", "MRT")
    flags[:, :, -3] |= np.uint16(f("Outlet"))
    flags[:, 0, :] = flags[:, -1, :] = f("Wall")
    flags[nz // 4:3 * nz // 4, ny // 4:3 * ny // 4,
          nx // 3:2 * nx // 3] |= np.uint16(f("DesignSpace", *prop, zone=1))
    lat.set_flags(flags)
    lat.set_setting("Porocity", 0.5, zone=1)
    lat.init()
    return lat


# d2q9_kuper_adj: the kuper rich state (torch_cases.paint_rich_kuper) with
# a DesignSpace block, the design wd in (0.5, 1.5) and both wall forces in
# the objective
KUPER_ADJ_SETTINGS = {**KUPER_SETTINGS, "WallForceXInObj": 1.0,
                      "WallForceYInObj": 0.5}


def paint_rich_kuper_adj(lat, seed):
    """``paint_rich_kuper`` on a d2q9_kuper_adj Lattice of either package,
    a DesignSpace block added (flags are painted first) and wd in (0.5,
    1.5)."""
    m = lat.model
    ny, nx = lat.shape
    flags = rich_flags_kuper(m, ny, nx)
    flags[ny // 4:3 * ny // 4, nx // 2:5 * nx // 8] |= np.uint16(
        m.flag_for("DesignSpace"))
    lat.set_flags(flags)
    lat.set_setting("Density", KUPER_VAPOUR, zone=1)
    lat.set_setting("Density", KUPER_WALL_DENSITY, zone=2)
    lat.init()
    rng = np.random.default_rng(seed)
    f = lat.fields_raw()
    planes = {f"f[{k}]": f[k] * (1 + 0.01 * rng.standard_normal(lat.shape))
              for k in range(9)}
    planes["wd"] = 0.5 + rng.random(lat.shape)
    lat.set_density_planes(planes)
    return lat


def kuper_adj_design_lattice(lattice_cls, model, dtype, shape=(16, 128),
                             design_rows=None, **kw):
    """tests/test_pallas_adjoint.py:test_pallas_kuper_gradient's case at
    ``shape``: MRT, a vapour drop (zone 1) in the liquid, walls top and
    bottom, the DesignSpace block (the middle half in y, or the rows
    ``design_rows = (y0, y1)``; x from 5/16 to 5/8 of nx), WallForceX the
    objective.  Initialised.  (On a tall lattice the middle half lies
    further from the walls than a short run's cotangents reach, and the
    design gradient is zero: pass rows by the walls.)"""
    ny, nx = shape
    y0, y1 = design_rows or (ny // 4, 3 * ny // 4)
    lat = lattice_cls(model, shape, dtype=dtype,
                      settings={"omega": 1.0, "Temperature": 0.56,
                                "FAcc": 1.0, "Magic": 0.01,
                                "MagicA": -0.152, "MagicF": -2.0 / 3.0,
                                "Density": 3.26, "WallForceXInObj": 1.0},
                      **kw)
    lat.set_setting("Density", 0.0145, zone=1)
    f = model.flag_for
    flags = np.full(shape, f("MRT"), dtype=np.uint16)
    yy, xx = np.mgrid[0:ny, 0:nx]
    r = ny * 3 / 8
    flags[((yy - ny / 2) ** 2 + (xx - nx * 50 / 128) ** 2) < r * r] = \
        f("MRT", zone=1)
    flags[0, :] = flags[-1, :] = f("Wall")
    flags[y0:y1, nx * 5 // 16:nx * 5 // 8] |= np.uint16(f("DesignSpace"))
    lat.set_flags(flags)
    lat.init()
    return lat
