"""Mitsuba 0.6 scene-XML loader (port of sdmm_tpu/scene/xml_loader.py, cut to
what the port renders).

It reads the same files the same way: ``<default>``, ``$var`` substitution
(``-D`` overrides take precedence) and ``<include>``; ``<ref>`` and
``twosided``; the perspective sensor with its film, sampler and rfilter;
the integrator's properties; every BSDF but irawan, with the bumpmap,
normalmap, blendbsdf, mixturebsdf, mask, coating and roughcoating
wrappers; bitmap textures (PNG decoded by ``utils/png.py``), ``scale`` and
the procedural textures (checkerboard, gridtexture, wireframe,
vertexcolors, curvature baked to vertex colours); area, constant, point,
spot, directional, collimated, envmap (an EXR through ``utils/exr.py``),
sky, sun and sunsky emitters; the rectangle, cube, sphere, disk, cylinder,
obj, serialized, ply, shapegroup and instance shapes; a scene-level
homogeneous medium, a shape's interior medium, homogeneous or
heterogeneous (a ``.vol`` density grid through ``scene/volume.py``), and
the dipole subsurface model with its material presets. Every feature the
port cannot render yet raises ``NotImplementedError`` at load time, naming
its ROADMAP item; a shape type the loader does not know is skipped, as the
reference skips it. A bitmap or env map whose file is missing or a git-lfs
stub becomes the reference's placeholder (a 4×4 mid-grey texture, a
constant environment of the map's scale, a thin unit-density fog for a
density grid), with a warning; a file that is there but cannot be decoded
raises.
"""

from __future__ import annotations

import os
import re
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from ..core.spectrum import interpolated_spectrum_to_rgb
from ..render.subsurface import lookup_material
from . import shapes as shp
from .scene import (
    BSDF_BLEND, BSDF_COATING, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
    BSDF_DIFFTRANS, BSDF_DIFFUSE, BSDF_HK, BSDF_MASK, BSDF_NULL, BSDF_PHONG,
    BSDF_PLASTIC, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHDIFFUSE, BSDF_ROUGHPLASTIC, BSDF_THINDIELECTRIC, BSDF_WARD,
    PROC_CHECKERBOARD, PROC_GRID, PROC_MESHATTR, PROC_WIREFRAME,
    SceneBuilder,
)
from .volume import load_vol

# Named conductor / dielectric materials (a subset of Mitsuba's ior tables).
CONDUCTOR_IOR = {
    "Cu": ([0.200438, 0.924033, 1.102212], [3.912949, 2.447786, 2.142188]),
    "Au": ([0.143085, 0.374852, 1.442371], [3.982205, 2.385723, 1.603215]),
    "Ag": ([0.155184, 0.116677, 0.138372], [4.827917, 3.122335, 2.146190]),
    "Al": ([1.657460, 0.880369, 0.521229], [9.223869, 6.269523, 4.837001]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}
DIELECTRIC_IOR = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "glass": 1.5046,
    "bk7": 1.5046, "diamond": 2.419, "polypropylene": 1.49,
}

# What the reference builds and the port does not render yet, by the
# ROADMAP item that ports it.
UNPORTED_BSDFS = {"irawan": "A9"}
UNPORTED_SHAPES = {"hair": "A8b", "heightfield": "A8b"}


def unported(what: str, item: str) -> NotImplementedError:
    """The error for ``what``, which ROADMAP item ``item`` ports."""
    return NotImplementedError(
        f"{what} is not ported to sdmm_tpu_torch yet (ROADMAP {item})")


def _subst(text: str, variables: dict) -> str:
    def repl(m):
        name = m.group(1)
        if name not in variables:
            raise KeyError(f"Undefined scene variable ${name}")
        return str(variables[name])

    return re.sub(r"\$(\w+)", repl, text)


def _parse_value(el, variables):
    return _subst(el.get("value", ""), variables)


def _parse_rgb(text: str) -> np.ndarray:
    text = text.strip()
    if text.startswith("#"):
        # HTML-style hex sRGB, linearised.
        h = text.lstrip("#")
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        srgb = np.array([int(h[i:i + 2], 16) for i in (0, 2, 4)]) / 255.0
        return np.where(srgb <= 0.04045, srgb / 12.92,
                        ((srgb + 0.055) / 1.055) ** 2.4)
    vals = [float(x) for x in re.split(r"[,\s]+", text) if x]
    if len(vals) == 1:
        vals = vals * 3
    return np.asarray(vals[:3])


def _parse_spectrum(text: str) -> np.ndarray:
    text = text.strip()
    if ":" in text:
        wl, vv = [], []
        for p in (p for p in re.split(r"[,\s]+", text) if p):
            a, b = p.split(":")
            wl.append(float(a))
            vv.append(float(b))
        return interpolated_spectrum_to_rgb(np.asarray(wl), np.asarray(vv))
    return _parse_rgb(text)


def _xyz(el, variables, default="0") -> np.ndarray:
    return np.array([float(_subst(el.get(ax, default), variables))
                     for ax in "xyz"])


def _parse_transform(el, variables) -> np.ndarray:
    m = np.eye(4)
    for child in el:
        tag = child.tag
        if tag == "matrix":
            vals = [float(x) for x in _parse_value(child, variables).split()]
            m = np.asarray(vals).reshape(4, 4) @ m
        elif tag == "translate":
            t = np.eye(4)
            t[:3, 3] = _xyz(child, variables)
            m = t @ m
        elif tag == "scale":
            s = np.eye(4)
            if child.get("value") is not None:
                v = float(_parse_value(child, variables))
                s[0, 0] = s[1, 1] = s[2, 2] = v
            else:
                s[:3, :3] = np.diag(_xyz(child, variables, "1"))
            m = s @ m
        elif tag == "rotate":
            axis = _xyz(child, variables)
            axis = axis / np.linalg.norm(axis)
            ang = np.deg2rad(float(_subst(child.get("angle", "0"), variables)))
            c, s_, x, y, z = np.cos(ang), np.sin(ang), *axis
            r = np.eye(4)
            r[:3, :3] = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s_,
                 x * z * (1 - c) + y * s_],
                [y * x * (1 - c) + z * s_, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s_],
                [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_,
                 c + z * z * (1 - c)],
            ])
            m = r @ m
        elif tag == "lookat":
            origin = _parse_rgb(_subst(child.get("origin"), variables))
            target = _parse_rgb(_subst(child.get("target"), variables))
            up = _parse_rgb(_subst(child.get("up", "0, 1, 0"), variables))
            d = target - origin
            d = d / np.linalg.norm(d)
            left = np.cross(up / np.linalg.norm(up), d)
            left /= np.linalg.norm(left)
            new_up = np.cross(d, left)
            look = np.eye(4)
            look[:3, 0] = left
            look[:3, 1] = new_up
            look[:3, 2] = d
            look[:3, 3] = origin
            m = look @ m
    return m


def _props(el, variables) -> dict:
    """Typed child properties (float/integer/boolean/string/rgb/spectrum/
    transform); a keyframed ``<animation>`` maps to ("animation", frames)."""
    out = {}
    for child in el:
        tag = child.tag
        name = child.get("name")
        if tag in ("float", "integer"):
            out[name] = float(_parse_value(child, variables))
        elif tag == "boolean":
            out[name] = _parse_value(child, variables).lower() == "true"
        elif tag == "string":
            out[name] = _parse_value(child, variables)
        elif tag == "rgb":
            out[name] = _parse_rgb(_parse_value(child, variables))
        elif tag == "spectrum":
            out[name] = _parse_spectrum(_parse_value(child, variables))
        elif tag == "transform":
            out[name] = _parse_transform(child, variables)
        elif tag == "animation":
            frames = sorted(
                ((float(sub.get("time", 0.0)),
                  _parse_transform(sub, variables))
                 for sub in child if sub.tag == "transform"),
                key=lambda f: f[0])
            out[name] = ("animation", frames)
    return out


class XMLLoader:
    def __init__(self, overrides: dict | None = None):
        self.variables = dict(overrides or {})
        self.overrides = dict(overrides or {})
        self.builder = SceneBuilder()
        self.base_dir = "."
        self.shapegroups: dict = {}
        # Texture code → (curvature kind, scale): a shape whose BSDF has a
        # curvature texture bakes it into vertex colours (_shape).
        self.curvature_notes: dict = {}

    def load(self, path: str) -> SceneBuilder:
        self.base_dir = os.path.dirname(os.path.abspath(path))
        self._scene(ET.parse(path).getroot(), self.base_dir)
        return self.builder

    def _scene(self, root, base_dir):
        for el in root:
            tag = el.tag
            if tag == "default":
                name = el.get("name")
                if name not in self.overrides:
                    self.variables.setdefault(name, el.get("value"))
            elif tag == "include":
                fname = _subst(el.get("filename"), self.variables)
                sub = os.path.join(base_dir, fname)
                if not os.path.exists(sub) and "_integrators" in fname:
                    # An integrator include the scene set does not ship:
                    # a bare integrator of the requested type.
                    self.builder.integrator = {
                        "type": self.variables.get("integrator", "path")}
                    continue
                self._scene(ET.parse(sub).getroot(), os.path.dirname(sub))
            elif tag == "integrator":
                self.builder.integrator = {
                    "type": _subst(el.get("type"), self.variables),
                    **_props(el, self.variables),
                }
                p = self.builder.integrator
                self.builder.max_depth = int(p.get("maxDepth", 10))
                self.builder.rr_depth = int(p.get("rrDepth",
                                                  self.builder.max_depth))
            elif tag == "sensor":
                self._sensor(el)
            elif tag == "medium":
                sigma_t, albedo, g = self._homogeneous(el)
                self.builder.medium = {"sigma_t": sigma_t, "albedo": albedo,
                                       "g": g}
            elif tag == "bsdf":
                self._bsdf(el)
            elif tag == "shape":
                self._shape(el, base_dir)
            elif tag == "emitter":
                self._emitter(el)

    def _phase_g(self, el) -> float:
        """The anisotropy g of a medium's <phase> (0 without one)."""
        g = 0.0
        for sub in el:
            if sub.tag == "phase":
                g = float(_props(sub, self.variables).get("g", 0.0))
        return g

    def _homogeneous(self, el):
        """(sigma_t, albedo, g) of a homogeneous <medium>: sigmaT with its
        albedo, or sigmaS and sigmaA."""
        p = _props(el, self.variables)
        if "sigmaT" in p:
            sigma_t = np.asarray(p["sigmaT"]).reshape(3)
            albedo = np.asarray(p.get("albedo", np.ones(3))).reshape(3)
        else:
            sigma_s = np.asarray(p.get("sigmaS", np.zeros(3))).reshape(3)
            sigma_a = np.asarray(p.get("sigmaA", np.zeros(3))).reshape(3)
            sigma_t = sigma_s + sigma_a
            albedo = np.where(sigma_t > 0,
                              sigma_s / np.maximum(sigma_t, 1e-20), 0.0)
        return sigma_t, albedo, self._phase_g(el)

    def _interior(self, el) -> int:
        """Register a shape's interior <medium>; returns its table id. A
        heterogeneous one reads its density grid from the <volume
        name="density"> file; its sigma_t is ``scale`` on every channel."""
        b = self.builder
        if el.get("type") != "heterogeneous":
            return b.add_medium(*self._homogeneous(el))
        p = _props(el, self.variables)
        density = None
        for ch in el:
            if ch.tag == "volume" and ch.get("name") == "density":
                path = _asset(self.base_dir,
                              _props(ch, self.variables).get("filename"),
                              "density grid", "a unit-density fog")
                if path is not None:
                    density, lo, hi = load_vol(path)
        if density is None:
            density, lo, hi = np.ones((2, 2, 2), np.float32), np.zeros(3), \
                np.ones(3)
        alb = np.asarray(p.get("albedo", 0.8), dtype=np.float64).reshape(-1)
        alb = alb if alb.size == 3 else np.full(3, float(alb[0]))
        return b.add_medium(np.full(3, float(p.get("scale", 1.0))), alb,
                            self._phase_g(el), density=density, vol_lo=lo,
                            vol_hi=hi)

    def _dipole(self, el) -> int:
        """Register a <subsurface type="dipole">: sigmaS/sigmaA, or
        sigmaT/albedo, or a material preset (skin1 by default), times
        ``scale``; eta intIOR / extIOR."""
        sp = _props(el, self.variables)

        def rgb(key, default):
            v = np.asarray(sp.get(key, default)).reshape(-1)
            return np.broadcast_to(v, (3,)) if v.size != 3 else v

        if "sigmaS" in sp or "sigmaA" in sp:
            sigma_s, sigma_a, eta_d = (rgb("sigmaS", np.zeros(3)),
                                       rgb("sigmaA", np.zeros(3)), 1.3)
        elif "sigmaT" in sp or "albedo" in sp:
            sigma_t = rgb("sigmaT", np.ones(3))
            sigma_s = rgb("albedo", np.full(3, 0.8)) * sigma_t
            sigma_a, eta_d = sigma_t - sigma_s, 1.3
        else:
            sigma_s, sigma_a, eta_d = lookup_material(
                sp.get("material", "skin1"))
        scale = float(sp.get("scale", 1.0))
        try:
            eta = float(sp.get("intIOR", eta_d)) / max(
                float(sp.get("extIOR", 1.0)), 1e-6)
        except (TypeError, ValueError):
            eta = eta_d
        return self.builder.add_subsurface(
            sigma_s * scale, sigma_a * scale, g=0.0, eta=eta,
            irr_samples=int(sp.get("irrSamples", 16)),
            sample_multiplier=float(sp.get("sampleMultiplier", 1.0)),
            quality=float(sp.get("quality", 0.2)))

    def _point(self, el, name):
        """The <point name=...> child of ``el``, or None."""
        for sub in el:
            if sub.tag == "point" and sub.get("name") == name:
                return _xyz(sub, self.variables)
        return None

    def _emitter(self, el):
        p = _props(el, self.variables)
        etype = el.get("type")
        b = self.builder
        z_axis = np.array([0.0, 0.0, 1.0])
        if etype == "constant":
            b.env_radiance = np.asarray(p.get("radiance",
                                              np.ones(3))).reshape(3)
        elif etype == "point":
            pos = self._point(el, "position")
            pos = np.zeros(3) if pos is None else pos
            if "toWorld" in p:
                pos = p["toWorld"][:3, 3]
            b.add_point_light(pos, np.asarray(
                p.get("intensity", np.ones(3))).reshape(3))
        elif etype in ("spot", "collimated"):
            # From toWorld's origin along its +z axis.
            m = p.get("toWorld", np.eye(4))
            if etype == "spot":
                cutoff = float(p.get("cutoffAngle", 20.0))
                b.add_spot_light(m[:3, 3], m[:3, :3] @ z_axis, np.asarray(
                    p.get("intensity", np.ones(3))).reshape(3), cutoff,
                    float(p.get("beamWidth", cutoff * 0.75)))
            else:
                b.add_collimated_light(m[:3, 3], m[:3, :3] @ z_axis,
                                       np.asarray(p.get(
                                           "power", np.ones(3))).reshape(3))
        elif etype == "directional":
            d = None
            for sub in el:
                if sub.tag == "vector" and sub.get("name") == "direction":
                    d = _xyz(sub, self.variables)
            if d is None:
                d = p.get("toWorld", np.eye(4))[:3, :3] @ z_axis
            b.add_directional_light(d, np.asarray(
                p.get("irradiance", np.ones(3))).reshape(3))
        elif etype == "envmap":
            from ..utils.exr import read_exr

            scale = float(p.get("scale", 1.0))
            b.env_radiance = np.full(3, scale)
            path = _asset(self.base_dir, p.get("filename"), "env map",
                          "a constant environment of its scale")
            if path is not None:
                b.env_map = np.asarray(read_exr(path)[..., :3], np.float32)
                if "toWorld" in p:
                    b.env_to_world = p["toWorld"][:3, :3]
        elif etype in ("sky", "sun", "sunsky"):
            from .sunsky import (compute_sun_coordinates, make_sunsky_envmap,
                                 sun_coords_to_dir)

            if "sunDirection" in p:
                sd = np.asarray(p["sunDirection"],
                                dtype=np.float64).reshape(-1)[:3]
            else:
                sd = sun_coords_to_dir(*compute_sun_coordinates(
                    year=int(p.get("year", 2010)),
                    month=int(p.get("month", 7)),
                    day=int(p.get("day", 10)),
                    hour=float(p.get("hour", 15.0)),
                    minute=float(p.get("minute", 0.0)),
                    second=float(p.get("second", 0.0)),
                    timezone=float(p.get("timezone", 9.0)),
                    latitude=float(p.get("latitude", 35.6894)),
                    longitude=float(p.get("longitude", 139.6917))))
            alb = np.asarray(p.get("albedo", 0.15),
                             dtype=np.float64).reshape(-1)
            alb = alb if alb.size == 3 else np.full(3, float(alb[0]))
            b.env_map = make_sunsky_envmap(
                sd, turbidity=float(p.get("turbidity", 3.0)),
                resolution=int(p.get("resolution", 256)),
                with_sky=etype in ("sky", "sunsky"),
                with_sun=etype in ("sun", "sunsky"),
                sun_scale=float(p.get("sunScale", 1.0)),
                sky_scale=float(p.get("skyScale", 1.0)),
                albedo=alb, stretch=float(p.get("stretch", 1.0)),
                sun_radius_scale=float(p.get("sunRadiusScale", 1.0)),
                extend=bool(p.get("extend", False)))
            b.env_radiance = np.full(3, float(p.get("scale", 1.0)))

    def _sensor(self, el):
        p = _props(el, self.variables)
        width, height = 256, 256
        for sub in el:
            if sub.tag == "film":
                fp = _props(sub, self.variables)
                width = int(fp.get("width", 256))
                height = int(fp.get("height", 256))
                for fsub in sub:
                    if fsub.tag == "rfilter":
                        rf = _subst(fsub.get("type", "box"), self.variables)
                        self.builder.rfilter = rf if rf in (
                            "box", "tent", "gaussian", "mitchell",
                            "catmullrom", "lanczos") else "box"
            elif sub.tag == "sampler":
                sp = _props(sub, self.variables)
                self.builder.sample_count = int(sp.get("sampleCount", 16))
                self.builder.seed = int(sp.get("seed", 1234))
                st = _subst(sub.get("type", "independent"), self.variables)
                self.builder.sampler = {
                    "independent": "independent", "stratified": "stratified",
                    "halton": "halton", "hammersley": "halton",
                    "ldsampler": "halton", "sobol": "sobol",
                }.get(st, "independent")
        self.builder.set_sensor(
            to_world=p.get("toWorld", np.eye(4)),
            fov_deg=float(p.get("fov", 45.0)),
            width=width, height=height, fov_axis=p.get("fovAxis", "x"))

    def _children(self, el, n: int) -> list[int]:
        """The ids of ``el``'s first ``n`` nested BSDFs (a diffuse one if
        there is none)."""
        subs = [sub for sub in el if sub.tag == "bsdf"][:n]
        kids = [self._bsdf(sub) for sub in subs]
        return kids or [self.builder.add_bsdf(BSDF_DIFFUSE)]

    def _bsdf(self, el) -> int:
        btype = _subst(el.get("type"), self.variables)
        name = el.get("id")
        b = self.builder
        if btype in UNPORTED_BSDFS:
            raise unported(f"the {btype} BSDF", UNPORTED_BSDFS[btype])
        p = _props(el, self.variables)
        if btype in ("twosided", "bumpmap", "normalmap"):
            # Wrappers flattened onto the child's row: reflective models
            # are two-sided here; a bump map sets the child's bump columns,
            # a normal map stores its texture as bump = -(id + 2).
            child = next((sub for sub in el if sub.tag == "bsdf"), None)
            idx = (self._bsdf(child) if child is not None
                   else b.add_bsdf(BSDF_DIFFUSE))
            if btype == "bumpmap":
                tex_id = self._bsdf_texture(el)
                if tex_id >= 0:
                    b.bsdfs[idx]["bump"] = tex_id
                    b.bsdfs[idx]["bump_scale"] = float(p.get("scale", 1.0))
            elif btype == "normalmap":
                tex_id = self._bsdf_texture(el, srgb=False)
                if tex_id >= 0:
                    b.bsdfs[idx]["bump"] = -(tex_id + 2)
            if name is not None:
                b.bsdf_ids[name] = idx
            return idx
        if btype == "blendbsdf":
            kids = self._children(el, 2)
            return b.add_bsdf(BSDF_BLEND, name=name, child0=kids[0],
                              child1=kids[1] if len(kids) > 1 else kids[0],
                              weight=float(p.get("weight", 0.5)))
        if btype == "mixturebsdf":
            # Two components map onto the blend container; with more, the
            # two largest weights are kept and renormalized.
            children = [sub for sub in el if sub.tag == "bsdf"]
            weights = [float(x) for x in str(p.get("weights", "")).replace(
                ",", " ").split()] or \
                [1.0 / max(len(children), 1)] * len(children)
            pairs = sorted(zip(weights, range(len(children))),
                           reverse=True)[:2]
            if len(pairs) == 1:
                return self._bsdf(children[pairs[0][1]])
            (w0, i0), (w1, i1) = pairs
            c0 = self._bsdf(children[i0])
            c1 = self._bsdf(children[i1])
            return b.add_bsdf(BSDF_BLEND, name=name, child0=c0, child1=c1,
                              weight=w1 / max(w0 + w1, 1e-9))
        if btype in ("coating", "roughcoating"):
            # The layer row: eta the IOR ratio, alpha the thickness,
            # albedo sigmaA, specular the reflectance, alpha_v the GGX
            # roughness of the boundary (0 = smooth).
            c0 = self._children(el, 1)[0]
            sa = np.asarray(p.get("sigmaA", np.zeros(3)),
                            np.float64).reshape(-1)
            return b.add_bsdf(
                BSDF_COATING, name=name, child0=c0,
                eta=_ior(p.get("intIOR", "bk7"), 1.5046)
                / _ior(p.get("extIOR", "air"), 1.000277),
                alpha=float(p.get("thickness", 1.0)),
                alpha_v=(float(p.get("alpha", 0.1))
                         if btype == "roughcoating" else 0.0),
                albedo=sa if sa.size == 3 else np.full(3, float(sa[0])),
                specular=p.get("specularReflectance", np.ones(3)))
        if btype == "mask":
            c0 = self._children(el, 1)[0]
            op = np.broadcast_to(np.asarray(
                p.get("opacity", np.full(3, 0.5))).reshape(-1), (3,))
            return b.add_bsdf(BSDF_MASK, name=name, child0=c0, albedo=op)
        kwargs = {}
        tex_id = self._bsdf_texture(el)
        if tex_id != -1:  # a bitmap id, or -(idx + 2) for a procedural one
            kwargs["tex"] = tex_id
        if btype in ("conductor", "roughconductor"):
            eta_k = CONDUCTOR_IOR.get(p.get("material", "Cu"),
                                      CONDUCTOR_IOR["Cu"])
            code = (BSDF_CONDUCTOR if btype == "conductor"
                    else BSDF_ROUGHCONDUCTOR)
            kwargs["specular"] = p.get("specularReflectance", np.ones(3))
            kwargs["eta"] = float(np.mean(np.asarray(p.get("eta", eta_k[0]))))
            kwargs["k"] = np.asarray(p.get("k", eta_k[1]))
            kwargs["alpha"] = float(p.get("alpha", 0.1))
        elif btype in ("dielectric", "roughdielectric", "thindielectric"):
            code = {"roughdielectric": BSDF_ROUGHDIELECTRIC,
                    "thindielectric": BSDF_THINDIELECTRIC}.get(
                        btype, BSDF_DIELECTRIC)
            kwargs["eta"] = (_ior(p.get("intIOR", "bk7"), 1.5046)
                             / _ior(p.get("extIOR", "air"), 1.000277))
            kwargs["specular"] = p.get("specularReflectance", np.ones(3))
            kwargs["albedo"] = p.get("specularTransmittance", np.ones(3))
            kwargs["alpha"] = float(p.get("alpha", 0.1))
        elif btype in ("phong", "ward"):
            code = BSDF_PHONG if btype == "phong" else BSDF_WARD
            kwargs["albedo"] = p.get("diffuseReflectance", np.full(3, 0.5))
            kwargs["specular"] = p.get("specularReflectance",
                                       np.full(3, 0.2))
            if btype == "phong":
                kwargs["exponent"] = float(p.get("exponent", 30.0))
            else:
                kwargs["alpha"] = float(p.get("alphaU", p.get("alpha", 0.1)))
                kwargs["alpha_v"] = float(p.get("alphaV",
                                                p.get("alpha", 0.1)))
        elif btype in ("roughplastic", "plastic"):
            code = (BSDF_ROUGHPLASTIC if btype == "roughplastic"
                    else BSDF_PLASTIC)
            kwargs["albedo"] = p.get("diffuseReflectance", np.full(3, 0.5))
            kwargs["specular"] = p.get("specularReflectance", np.ones(3))
            kwargs["eta"] = (_ior(p.get("intIOR", "polypropylene"), 1.49)
                             / _ior(p.get("extIOR", "air"), 1.000277))
            kwargs["alpha"] = float(p.get("alpha", 0.1))
        elif btype == "roughdiffuse":
            code = BSDF_ROUGHDIFFUSE
            kwargs["albedo"] = p.get("reflectance", np.full(3, 0.5))
            kwargs["alpha"] = float(p.get("alpha", 0.2))
        elif btype == "difftrans":
            code = BSDF_DIFFTRANS
            kwargs["albedo"] = p.get("transmittance", np.full(3, 0.5))
        elif btype == "hk":
            # Hanrahan-Krueger slab from sigmaS/sigmaA or sigmaT + albedo;
            # a nested hg phase sets g (carried in eta).
            code = BSDF_HK

            def rgb(v):
                return np.broadcast_to(np.asarray(
                    v, np.float64).reshape(-1), (3,)).astype(np.float64)

            if "sigmaT" in p:
                sig_t = rgb(p["sigmaT"])
                sig_s = sig_t * rgb(p.get("albedo", 0.8))
                sig_a = sig_t - sig_s
            else:
                sig_s = rgb(p.get("sigmaS", 2.0))
                sig_a = rgb(p.get("sigmaA", 0.05))
            g = 0.0
            for sub in el:
                if sub.tag == "phase" and sub.get("type") == "hg":
                    g = float(_props(sub, self.variables).get("g", 0.0))
            kwargs.update(albedo=sig_s, specular=sig_a,
                          alpha=float(p.get("thickness", 1.0)), eta=g)
        else:  # diffuse, and any type Mitsuba's subset does not know
            code = BSDF_DIFFUSE
            kwargs["albedo"] = p.get("reflectance", np.full(3, 0.5))
        return b.add_bsdf(code, name=name, **kwargs)

    def _bsdf_texture(self, el, srgb: bool = True) -> int:
        """The id of ``el``'s first nested <texture> (a bitmap id, or
        -(idx + 2) for a procedural one), or -1. ``srgb=False`` keeps the
        raw values (normal maps store vectors)."""
        for sub in el:
            if sub.tag == "texture":
                return self._texture(sub, srgb=srgb)
        return -1

    def _texture(self, sub, srgb: bool = True, mul: float = 1.0) -> int:
        """One <texture> → texture id: bitmap, scale (a factor on the
        texture it wraps) and the procedural kinds, lowered to proc_tex
        rows; an unknown kind builds none (-1)."""
        ttype = sub.get("type")
        tp = _props(sub, self.variables)
        b = self.builder

        def spec(name, default):
            v = tp.get(name, None)
            if v is None:
                return np.full(3, default)
            return np.broadcast_to(np.asarray(v, np.float64).reshape(-1),
                                   (3,)).copy()

        uvkw = dict(uscale=float(tp.get("uscale", 1.0)),
                    vscale=float(tp.get("vscale", 1.0)),
                    uoffset=float(tp.get("uoffset", 0.0)),
                    voffset=float(tp.get("voffset", 0.0)))
        if ttype == "bitmap":
            from ..utils.png import load_bitmap

            path = _asset(self.base_dir, tp.get("filename"), "bitmap",
                          "a 4x4 mid-grey texture")
            if path is None:
                img = np.full((4, 4, 3), 0.5, np.float32)
            else:
                img = load_bitmap(path)
                if srgb:
                    img = img ** 2.2  # sRGB → linear (approximate)
            return b.add_texture(img * mul)
        if ttype == "scale":
            s = float(tp.get("scale", tp.get("value", 1.0)))
            for ssub in sub:
                if ssub.tag == "texture":
                    return self._texture(ssub, srgb=srgb, mul=mul * s)
            return -1
        if ttype == "checkerboard":
            return b.add_proc_texture(
                PROC_CHECKERBOARD, color0=spec("color0", 0.4) * mul,
                color1=spec("color1", 0.2) * mul, **uvkw)
        if ttype == "gridtexture":
            return b.add_proc_texture(
                PROC_GRID, color0=spec("color0", 0.2) * mul,
                color1=spec("color1", 0.4) * mul,
                line_width=float(tp.get("lineWidth", 0.01)), **uvkw)
        if ttype == "wireframe":
            return b.add_proc_texture(
                PROC_WIREFRAME, color0=spec("edgeColor", 0.1) * mul,
                color1=spec("interiorColor", 0.5) * mul,
                line_width=float(tp.get("lineWidth", 0.0)),
                step_width=min(max(float(tp.get("stepWidth", 0.5)), 0.0),
                               1.0))
        if ttype == "vertexcolors":
            return b.add_proc_texture(PROC_MESHATTR)
        if ttype == "curvature":
            code = b.add_proc_texture(PROC_MESHATTR)
            self.curvature_notes[code] = (tp.get("curvature", "gaussian"),
                                          float(tp.get("scale", 1.0)))
            return code
        return -1

    def _shape(self, el, base_dir, collect: list | None = None):
        """Parse one <shape>. With ``collect`` set, members are gathered
        into the list instead of added to the scene (shapegroup bodies)."""
        stype = _subst(el.get("type"), self.variables)
        p = _props(el, self.variables)
        to_world = p.get("toWorld", np.eye(4))
        if isinstance(to_world, tuple) and to_world[0] == "animation":
            raise unported("keyframed motion", "A8b")
        flip = bool(p.get("flipNormals", False))

        if stype == "shapegroup":
            members: list = []
            for sub in el:
                if sub.tag == "shape":
                    self._shape(sub, base_dir, collect=members)
            if el.get("id"):
                self.shapegroups[el.get("id")] = members
            return
        if stype == "instance":
            # Flattened into transformed triangle copies.
            for sub in el:
                if sub.tag == "ref" and sub.get("id") in self.shapegroups:
                    for soup, b_i, e_i, m_i in self.shapegroups[sub.get("id")]:
                        self.builder.add_shape(soup.transformed(to_world),
                                               b_i, e_i, interior=m_i)
            return

        bsdf_idx = None
        emitter_idx = -1
        interior_med = 0
        sss_idx = -1
        for sub in el:
            if sub.tag == "subsurface" and sub.get("type") == "dipole":
                sss_idx = self._dipole(sub)
            elif sub.tag == "ref":
                ref_id = sub.get("id")
                if ref_id in self.builder.bsdf_ids:
                    bsdf_idx = self.builder.bsdf_ids[ref_id]
            elif sub.tag == "bsdf":
                bsdf_idx = self._bsdf(sub)
            elif sub.tag == "emitter" and sub.get("type") == "area":
                ep = _props(sub, self.variables)
                emitter_idx = self.builder.add_emitter(
                    np.asarray(ep.get("radiance", np.ones(3))).reshape(3))
            elif sub.tag == "medium" and \
                    sub.get("name", "interior") == "interior":
                interior_med = self._interior(sub)
        if bsdf_idx is None:
            # A shape with a medium and no BSDF is an invisible boundary.
            bsdf_idx = (self.builder.add_bsdf(BSDF_NULL) if interior_med
                        else self.builder.add_bsdf(BSDF_DIFFUSE,
                                                   albedo=np.full(3, 0.5)))
        if stype in UNPORTED_SHAPES:
            if stype == "heightfield" and not self._heightfield_file(el, p):
                return  # heights from a procedural texture: none built
            raise unported(f"the {stype} shape", UNPORTED_SHAPES[stype])

        if stype == "rectangle":
            soup = shp.make_rectangle(to_world, flip)
        elif stype == "cube":
            soup = shp.make_cube(to_world, flip)
        elif stype == "sphere":
            center = np.zeros(3)
            for sub in el:
                if sub.tag == "point" and sub.get("name") == "center":
                    center = _xyz(sub, self.variables)
            soup = shp.make_sphere(center, float(p.get("radius", 1.0)),
                                   to_world, flip_normals=flip)
        elif stype == "disk":
            soup = shp.make_disk(to_world, flip_normals=flip)
        elif stype == "cylinder":
            pts = {"p0": np.zeros(3), "p1": np.array([0.0, 0.0, 1.0])}
            for sub in el:
                if sub.tag == "point" and sub.get("name") in pts:
                    pts[sub.get("name")] = _xyz(sub, self.variables)
            soup = shp.make_cylinder(pts["p0"], pts["p1"],
                                     float(p.get("radius", 1.0)), to_world,
                                     flip_normals=flip)
        elif stype == "obj":
            soup = shp.load_obj(
                os.path.join(base_dir, p.get("filename")), to_world, flip,
                face_normals=bool(p.get("faceNormals", False)))
        elif stype in ("serialized", "ply"):
            from .serialized import load_ply, load_serialized

            fname = os.path.join(base_dir, p.get("filename"))
            mesh = (load_serialized(fname, int(p.get("shapeIndex", 0)))
                    if stype == "serialized" else load_ply(fname))
            if bool(p.get("faceNormals", False)):
                mesh["face_normals"] = True
            soup = shp.mesh_to_soup(mesh, to_world, flip)
        else:
            return  # a shape type the loader does not know: skipped
        code = self.builder.bsdfs[bsdf_idx]["tex"]
        if code in self.curvature_notes:
            kind, scale = self.curvature_notes[code]
            soup = shp.bake_curvature(soup, kind=kind, scale=scale)
        if collect is not None:
            collect.append((soup, bsdf_idx, emitter_idx, interior_med))
        else:
            self.builder.add_shape(soup, bsdf_idx, emitter_idx,
                                   interior=interior_med, sss=sss_idx)

    def _heightfield_file(self, el, p) -> str:
        """The height file of a heightfield: its own or its texture's."""
        fname = p.get("filename", "")
        for sub in el:
            if not fname and sub.tag == "texture":
                fname = _props(sub, self.variables).get("filename", "")
        return fname


def _ior(v, default: float) -> float:
    """An IOR given as a number or a material name."""
    return DIELECTRIC_IOR.get(v, default) if isinstance(v, str) else float(v)


def _asset(base_dir: str, fname: str | None, what: str, placeholder: str):
    """The path of a texture or env-map file; None, with a warning, where
    the file is missing or a git-lfs stub (the caller then uses its
    placeholder)."""
    path = os.path.join(base_dir, fname) if fname else None
    reason = None
    if path is None or not os.path.isfile(path):
        reason = "is missing"
    else:
        try:
            shp.check_lfs_stub(path)
        except ValueError:
            reason = "is a git-lfs stub"
    if reason is None:
        return path
    warnings.warn(f"{what} file {path or '(none named)'} {reason}: using "
                  f"{placeholder}", stacklevel=3)
    return None


def load_scene(path: str, overrides: dict | None = None) -> SceneBuilder:
    """The ``SceneBuilder`` of a scene file; ``.build(device=...)`` gives
    the device scene."""
    return XMLLoader(overrides).load(path)
