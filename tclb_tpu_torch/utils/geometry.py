"""Geometry: XML-driven voxel painter for the node-type flag field.

Behavioral parity with the reference Geometry (reference
src/Geometry.{h,cpp.Rt}): regions with the dx/fx/nx attribute algebra and
negative-offset convention (src/Geometry.cpp.Rt:217-307), the primitives
Box, Wedge and Sphere and named Zone references (Draw, :636-886), paint modes
overwrite/fill/change with a foreground mask (Dot, :310-322), the settings
zone registry (setZone, :196-214), and the built-in default zones
Inlet/Outlet/Channel/Tunnel (src/def.cpp.Rt:10-33).

Primitives rasterize as numpy boolean masks over coordinate grids
(vectorized, not per-voxel ``Dot`` calls); the painted uint16 array is pushed
to the device once via ``Lattice.set_flags``.  This is the PyTorch port's own
copy of the JAX package's painter (numpy only); the other primitives
(``UNPORTED_PRIMITIVES``) raise and wait for ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.utils.units import UnitEnv

MODE_OVERWRITE = 0
MODE_FILL = 1
MODE_CHANGE = 2
_MODES = {"overwrite": MODE_OVERWRITE, "fill": MODE_FILL,
          "change": MODE_CHANGE}

# primitives of the JAX package's painter that this port does not draw yet
UNPORTED_PRIMITIVES = ("HalfSphere", "OffgridSphere", "Pipe", "OffgridPipe",
                       "Sweep", "Text", "PythonInline", "STL")

# default named zones (reference xml_definition, src/def.cpp.Rt:10-26):
# each zone is a list of Box-attribute dicts
DEFAULT_ZONES: dict[str, list[dict[str, str]]] = {
    "Inlet": [dict(dx="0", fx="0", dy="0", fy="-1", dz="0", fz="-1")],
    "Outlet": [dict(dx="-1", fx="-1", dy="0", fy="-1", dz="0", fz="-1")],
    "Channel": [
        dict(dx="0", dy="0", dz="0", fx="-1", fy="0", fz="-1"),
        dict(dx="0", dy="-1", dz="0", fx="-1", fy="-1", fz="-1"),
    ],
    "Tunnel": [
        dict(dx="0", dy="0", dz="0", fx="-1", fy="0", fz="-1"),
        dict(dx="0", dy="-1", dz="0", fx="-1", fy="-1", fz="-1"),
        dict(dx="0", dy="0", dz="0", fx="-1", fy="-1", fz="0"),
        dict(dx="0", dy="0", dz="-1", fx="-1", fy="-1", fz="-1"),
    ],
}


@dataclass
class Region:
    """An axis-aligned box: offset + extent per axis (reference lbRegion,
    src/Region.h)."""

    dx: int = 0
    dy: int = 0
    dz: int = 0
    nx: int = 1
    ny: int = 1
    nz: int = 1

    def intersect(self, o: "Region") -> "Region":
        dx, dy, dz = (max(self.dx, o.dx), max(self.dy, o.dy),
                      max(self.dz, o.dz))
        return Region(
            dx, dy, dz,
            max(0, min(self.dx + self.nx, o.dx + o.nx) - dx),
            max(0, min(self.dy + self.ny, o.dy + o.ny) - dy),
            max(0, min(self.dz + self.nz, o.dz + o.nz) - dz))

    @property
    def size(self) -> int:
        return self.nx * self.ny * self.nz


class Geometry:
    """Paints a ``(nz, ny, nx)``/``(ny, nx)`` uint16 flag array from an XML
    geometry tree."""

    def __init__(self, model: Model, shape: tuple[int, ...],
                 units: UnitEnv | None = None):
        self.model = model
        self.shape = tuple(shape)
        self.ndim = len(shape)
        if self.ndim == 2:
            ny, nx = shape
            nz = 1
        else:
            nz, ny, nx = shape
        self.region = Region(0, 0, 0, nx, ny, nz)
        self.units = units or UnitEnv()
        self.flags = np.zeros((nz, ny, nx), dtype=np.uint16)
        # settings-zone registry (reference SettingZones; zone 0 = default)
        self.setting_zones: dict[str, int] = {"DefaultZone": 0}
        # named zone shapes added by <Zone name=...> elements
        self.zones: dict[str, list[ET.Element]] = {}
        # foreground paint state
        self._fg = 0
        self._fg_mask = 0xFFFF
        self._fg_mode = MODE_OVERWRITE

    # -- attribute helpers -------------------------------------------------- #

    def _val(self, el: ET.Element, name: str, default=None) -> int:
        a = el.get(name)
        if a is None:
            if default is None:
                raise ValueError(f"<{el.tag}> missing attribute {name!r}")
            return default
        return int(round(self.units.alt(a)))

    def _val_p(self, el: ET.Element, name: str) -> tuple[int, str]:
        """Value with optional '<'/'>' prefix (reference val_p,
        src/Geometry.cpp.Rt:116-131)."""
        a = el.get(name)
        side = "+"
        if a and a[0] in "<>":
            side, a = a[0], a[1:]
        return int(round(self.units.alt(a))), side

    # -- region algebra ----------------------------------------------------- #

    def get_region(self, el: ET.Element | None,
                   parents: dict[ET.Element, ET.Element]) -> Region:
        """Region from dx/dy/dz ('<' measures from the far side; negative
        '+' values wrap), fx/fy/fz (far corner, negative wraps) and
        nx/ny/nz, resolved against the parent element's region (reference
        getRegion, src/Geometry.cpp.Rt:217-307)."""
        if el is None:
            return Region(0, 0, 0, self.region.nx, self.region.ny,
                          self.region.nz)
        ret = self.get_region(parents.get(el), parents)
        for ax in ("x", "y", "z"):
            if el.get("d" + ax) is not None:
                w, side = self._val_p(el, "d" + ax)
                n = getattr(ret, "n" + ax)
                if side == "<":
                    w = n + w
                elif side == "+" and w < 0:
                    w = n + w
                setattr(ret, "d" + ax, getattr(ret, "d" + ax) + w)
                setattr(ret, "n" + ax, n - w)
        for ax in ("x", "y", "z"):
            if el.get("f" + ax) is not None:
                w = self._val(el, "f" + ax)
                if w < 0:
                    w = getattr(ret, "n" + ax) + w + getattr(ret, "d" + ax)
                setattr(ret, "n" + ax, w - getattr(ret, "d" + ax) + 1)
        for ax in ("x", "y", "z"):
            if el.get("n" + ax) is not None:
                setattr(ret, "n" + ax, self._val(el, "n" + ax))
        return ret

    # -- paint state -------------------------------------------------------- #

    def set_flag(self, name: str) -> None:
        """Select foreground node type; its mask is the union of group masks
        covering it (reference setFlag + the generated Type table with the
        smallest covering mask, src/def.cpp.Rt:27-31)."""
        t = self.model.node_types[name]
        # smallest group mask that covers this type's value (reference picks
        # the min Node_Group >= value); our packing makes that the type's
        # own group mask
        self._fg = t.value
        self._fg_mask = t.mask
        self._fg_mode = MODE_OVERWRITE

    def set_mask(self, name: str) -> None:
        self._fg_mask = self.model.group_masks[name]

    def set_mode(self, mode: str) -> None:
        self._fg_mode = _MODES[mode]

    def set_zone(self, name: str) -> None:
        """Allocate/reuse a settings-zone id and fold it into the foreground
        flag's high bits (reference setZone, src/Geometry.cpp.Rt:196-214)."""
        if name not in self.setting_zones:
            self.setting_zones[name] = len(self.setting_zones)
        zid = self.setting_zones[name]
        if zid >= self.model.zone_max:
            raise ValueError(f"too many settings zones ({zid})")
        zmask = self.model.group_masks["SETTINGZONE"]
        self._fg = (self._fg & ~zmask) | (zid << self.model.zone_shift)
        self._fg_mask |= zmask

    # -- painting ----------------------------------------------------------- #

    def _paint(self, mask_xyz: np.ndarray, reg: Region) -> None:
        """Apply the foreground flag under ``mask_xyz`` (bool, region-shaped,
        indexed [z,y,x]) honoring mode+mask (reference Dot,
        src/Geometry.cpp.Rt:310-322)."""
        clip = self.region.intersect(reg)
        if clip.size == 0:
            return
        sl = (slice(clip.dz, clip.dz + clip.nz),
              slice(clip.dy, clip.dy + clip.ny),
              slice(clip.dx, clip.dx + clip.nx))
        sub = self.flags[sl]
        m = mask_xyz[clip.dz - reg.dz:clip.dz - reg.dz + clip.nz,
                     clip.dy - reg.dy:clip.dy - reg.dy + clip.ny,
                     clip.dx - reg.dx:clip.dx - reg.dx + clip.nx]
        if self._fg_mode == MODE_FILL:
            m = m & ((sub & self._fg_mask) == 0)
        elif self._fg_mode == MODE_CHANGE:
            m = m & ((sub & self._fg_mask) != 0)
        self.flags[sl] = np.where(
            m, (sub & ~np.uint16(self._fg_mask)) | np.uint16(self._fg), sub)

    def _grid(self, reg: Region):
        """Coordinate grids (z, y, x each region-shaped, indexed [z,y,x])."""
        z, y, x = np.meshgrid(
            np.arange(reg.dz, reg.dz + reg.nz),
            np.arange(reg.dy, reg.dy + reg.ny),
            np.arange(reg.dx, reg.dx + reg.nx), indexing="ij")
        return z, y, x

    def draw(self, node: ET.Element) -> None:
        """Rasterize every child primitive of ``node`` (reference Draw,
        src/Geometry.cpp.Rt:636-886)."""
        parents = {c: p for p in node.iter() for c in p}
        for n in node:
            reg = self.get_region(n, parents)
            tag = n.tag
            if tag == "Box":
                self._paint(np.ones((reg.nz, reg.ny, reg.nx), bool), reg)
            elif tag == "Wedge":
                direction = n.get("direction", "UpperLeft") or "UpperLeft"
                z, y, x = self._grid(reg)
                xs = (x - reg.dx) / max(reg.nx - 1.0, 1.0)
                ys = (y - reg.dy) / max(reg.ny - 1.0, 1.0)
                if direction in ("UpperRight", "LowerRight"):
                    xs = 1.0 - xs
                if direction in ("LowerLeft", "LowerRight"):
                    ys = 1.0 - ys
                self._paint((xs - ys) < 1e-10, reg)
            elif tag == "Sphere":
                # the ellipsoid inscribed in the region, tested at the
                # node centres
                z, y, x = self._grid(reg)
                xs = 2 * (0.5 + x - reg.dx) / reg.nx - 1
                ys = 2 * (0.5 + y - reg.dy) / reg.ny - 1
                zs = 2 * (0.5 + z - reg.dz) / reg.nz - 1
                self._paint(xs * xs + ys * ys + zs * zs < 1, reg)
            elif tag in UNPORTED_PRIMITIVES:
                raise NotImplementedError(
                    f"<{tag}> geometry is not ported to PyTorch yet (ROADMAP "
                    "queue 1, item 6)")
            elif tag == "Zone" or tag in self.zones or tag in DEFAULT_ZONES:
                self._draw_zone(n, reg)
            else:
                raise ValueError(f"unknown geometry primitive <{tag}>")

    def _draw_zone(self, n: ET.Element, reg: Region) -> None:
        """A named zone reference re-rasterizes the zone's stored shapes
        (reference keeps Zone shapes in a dictionary merged from xml_def,
        src/Geometry.cpp.Rt:905-917)."""
        name = n.get("name", n.tag) if n.tag == "Zone" else n.tag
        if n.tag == "Zone" and len(n):
            # definition: store children
            self.zones[name] = list(n)
            return
        shapes = self.zones.get(name)
        if shapes is None:
            boxes = DEFAULT_ZONES.get(name)
            if boxes is None:
                raise ValueError(f"unknown zone {name!r}")
            holder = ET.Element("Geometry")
            for attrs in boxes:
                ET.SubElement(holder, "Box", attrs)
            shapes = list(holder)
        holder = ET.Element("Geometry")
        holder.extend(shapes)
        self.draw(holder)

    # -- top-level load ----------------------------------------------------- #

    def load(self, root: ET.Element) -> None:
        """Process a <Geometry> tree: per child, set flag from tag name plus
        mask/mode/zone attributes, then rasterize grandchildren (reference
        Geometry::load, src/Geometry.cpp.Rt:905-950)."""
        for child in root:
            if child.tag == "Zone" and len(child):
                self.zones[child.get("name", "")] = list(child)
                continue
            self.set_flag(child.tag)
            for aname, aval in child.attrib.items():
                if aname == "mask":
                    self.set_mask(aval)
                elif aname == "mode":
                    self.set_mode(aval)
                elif aname == "name":
                    self.set_zone(aval)
            if len(child):
                self.draw(child)
            else:
                # no shape children: paint a Box over the element's OWN
                # region attributes (e.g. <Wall dx="0" fx="5"/> is the
                # first six columns, not the whole domain — reference
                # Geometry::load treats the element itself as the region,
                # src/Geometry.cpp.Rt:905-950)
                holder = ET.Element("g")
                ET.SubElement(holder, "Box", {
                    k: v for k, v in child.attrib.items()
                    if k not in ("mask", "mode", "name")})
                self.draw(holder)

    def result(self) -> np.ndarray:
        """Painted flags, shaped for the model's dimensionality."""
        if self.ndim == 2:
            return self.flags[0]
        return self.flags



# --------------------------------------------------------------------------- #
# Q-cut painting (interpolated bounce-back wall distances)
# --------------------------------------------------------------------------- #


def cuts_from_sdf(sdf, shape, E) -> np.ndarray:
    """Per-direction wall-cut distances from a signed distance function
    (the host-side analogue of the reference's cut generation consumed by
    Lattice::CutsOverwrite; -1 is no cut and the fraction stays a float
    where the reference quantizes it to 0.005 steps).

    ``sdf(coords)`` maps an (ndim, *shape) array of node coordinates
    (index order matching ``shape``: z, y, x / y, x) to signed distances,
    positive in the fluid and negative in the solid.  For every fluid node
    whose ``E[i]`` neighbour is solid, the cut fraction along the link is
    the linear interpolation of the surface crossing
    ``q = sdf(x) / (sdf(x) - sdf(x + e_i))``.

    Returns (len(E) - 1, *shape) float32, aligned with ``E[1:]``."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    grids = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                        indexing="ij")
    coords = np.stack(grids)
    d0 = np.asarray(sdf(coords), dtype=np.float64)
    out = np.full((len(E) - 1,) + shape, -1.0, dtype=np.float32)
    for i in range(1, len(E)):
        # E rows are (dx[, dy[, dz]]), x first; the index order is reversed
        off = np.array(list(E[i][::-1]) + [0] * (ndim - len(E[i])),
                       dtype=np.float64)[:ndim]
        dn = np.asarray(sdf(coords + off.reshape((ndim,) + (1,) * ndim)),
                        dtype=np.float64)
        crossing = (d0 > 0.0) & (dn <= 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = d0 / (d0 - dn)
        out[i - 1] = np.where(crossing, np.clip(q, 0.0, 1.0), -1.0)
    return out


def sphere_sdf(center, radius):
    """SDF of a solid sphere (or a cylinder extruded along the leading
    axes, given fewer centre components than dimensions): negative inside,
    coordinates in index order as :func:`cuts_from_sdf` passes them."""
    center = np.asarray(center, dtype=np.float64)

    def sdf(coords):
        nd = coords.shape[0]
        use = coords[nd - len(center):]
        r = np.sqrt(sum((use[k] - center[k]) ** 2
                        for k in range(len(center))))
        return r - radius
    return sdf
