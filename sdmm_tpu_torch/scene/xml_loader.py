"""Mitsuba 0.6 scene-XML loader (port of sdmm_tpu/scene/xml_loader.py, cut to
what the port renders).

It reads the same files the same way: ``<default>``, ``$var`` substitution
(``-D`` overrides take precedence) and ``<include>``; ``<ref>`` and
``twosided``; the perspective sensor with its film, sampler and rfilter;
the integrator's properties; the diffuse, conductor, roughconductor and
dielectric BSDFs; area emitters and a constant environment; the rectangle,
cube, sphere, disk, cylinder, obj, serialized, ply, shapegroup and instance
shapes. Every feature the port cannot render yet raises
``NotImplementedError`` at load time, naming its ROADMAP item; a shape type
the loader does not know is skipped, as the reference skips it.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from ..core.spectrum import interpolated_spectrum_to_rgb
from . import shapes as shp
from .scene import (
    BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_ROUGHCONDUCTOR,
    SceneBuilder,
)

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
UNPORTED_BSDFS = {
    name: "A9" for name in (
        "bumpmap", "normalmap", "blendbsdf", "mixturebsdf", "mask",
        "coating", "roughcoating", "roughdiffuse", "difftrans",
        "roughdielectric", "thindielectric", "phong", "ward", "plastic",
        "roughplastic", "irawan", "hk")
}
UNPORTED_EMITTERS = {
    name: "A8b" for name in ("point", "spot", "directional", "collimated",
                             "envmap", "sky", "sun", "sunsky")
}
UNPORTED_SHAPES = {"hair": "A8b", "heightfield": "A8b"}
TEXTURES = ("bitmap", "checkerboard", "gridtexture", "wireframe",
            "vertexcolors", "curvature")


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
                raise unported("a participating medium", "A9")
            elif tag == "bsdf":
                self._bsdf(el)
            elif tag == "shape":
                self._shape(el, base_dir)
            elif tag == "emitter":
                etype = el.get("type")
                if etype == "constant":
                    p = _props(el, self.variables)
                    self.builder.env_radiance = np.asarray(
                        p.get("radiance", np.ones(3))).reshape(3)
                elif etype in UNPORTED_EMITTERS:
                    raise unported(f"the {etype} emitter",
                                    UNPORTED_EMITTERS[etype])

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

    def _texture_builds(self, el) -> bool:
        """Whether the reference would build a texture from ``el``'s first
        ``<texture>`` child (an unknown kind builds none)."""
        for sub in el:
            if sub.tag == "texture":
                ttype = sub.get("type")
                if ttype == "scale":
                    return self._texture_builds(sub)
                return ttype in TEXTURES
        return False

    def _bsdf(self, el) -> int:
        btype = _subst(el.get("type"), self.variables)
        name = el.get("id")
        if btype == "twosided":
            # Reflective models are two-sided here: unwrap the child.
            child = next(sub for sub in el if sub.tag == "bsdf")
            idx = self._bsdf(child)
            if name is not None:
                self.builder.bsdf_ids[name] = idx
            return idx
        if btype in UNPORTED_BSDFS:
            raise unported(f"the {btype} BSDF", UNPORTED_BSDFS[btype])
        if self._texture_builds(el):
            raise unported("a textured BSDF", "A8b")
        p = _props(el, self.variables)
        kwargs = {}
        if btype in ("conductor", "roughconductor"):
            eta_k = CONDUCTOR_IOR.get(p.get("material", "Cu"),
                                      CONDUCTOR_IOR["Cu"])
            code = (BSDF_CONDUCTOR if btype == "conductor"
                    else BSDF_ROUGHCONDUCTOR)
            kwargs["specular"] = p.get("specularReflectance", np.ones(3))
            kwargs["eta"] = float(np.mean(np.asarray(p.get("eta", eta_k[0]))))
            kwargs["k"] = np.asarray(p.get("k", eta_k[1]))
            kwargs["alpha"] = float(p.get("alpha", 0.1))
        elif btype == "dielectric":
            int_ior = p.get("intIOR", "bk7")
            ext_ior = p.get("extIOR", "air")
            int_v = (DIELECTRIC_IOR.get(int_ior, 1.5046)
                     if isinstance(int_ior, str) else float(int_ior))
            ext_v = (DIELECTRIC_IOR.get(ext_ior, 1.000277)
                     if isinstance(ext_ior, str) else float(ext_ior))
            code = BSDF_DIELECTRIC
            kwargs["eta"] = int_v / ext_v
            kwargs["specular"] = p.get("specularReflectance", np.ones(3))
            kwargs["albedo"] = p.get("specularTransmittance", np.ones(3))
            kwargs["alpha"] = float(p.get("alpha", 0.1))
        else:  # diffuse, and any type Mitsuba's subset does not know
            code = BSDF_DIFFUSE
            kwargs["albedo"] = p.get("reflectance", np.full(3, 0.5))
        return self.builder.add_bsdf(code, name=name, **kwargs)

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
                    for soup, b_i, e_i in self.shapegroups[sub.get("id")]:
                        self.builder.add_shape(soup.transformed(to_world),
                                               b_i, e_i)
            return

        bsdf_idx = None
        emitter_idx = -1
        for sub in el:
            if sub.tag == "subsurface" and sub.get("type") == "dipole":
                raise unported("dipole subsurface scattering", "A9")
            if sub.tag == "ref":
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
                raise unported("a participating medium", "A9")
        if bsdf_idx is None:
            bsdf_idx = self.builder.add_bsdf(BSDF_DIFFUSE,
                                             albedo=np.full(3, 0.5))
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
        if collect is not None:
            collect.append((soup, bsdf_idx, emitter_idx))
        else:
            self.builder.add_shape(soup, bsdf_idx, emitter_idx)

    def _heightfield_file(self, el, p) -> str:
        """The height file of a heightfield: its own or its texture's."""
        fname = p.get("filename", "")
        for sub in el:
            if not fname and sub.tag == "texture":
                fname = _props(sub, self.variables).get("filename", "")
        return fname


def load_scene(path: str, overrides: dict | None = None) -> SceneBuilder:
    """The ``SceneBuilder`` of a scene file; ``.build(device=...)`` gives
    the device scene."""
    return XMLLoader(overrides).load(path)
