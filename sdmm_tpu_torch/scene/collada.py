"""COLLADA (.dae) import, the ``mtsimport`` of the port (port of
sdmm_tpu/scene/collada.py).

``load_dae`` reads the COLLADA subset that typical exports use:
library_geometries (triangles and polylist primitives, polygons as fans,
with POSITION/NORMAL/TEXCOORD inputs), node transform stacks (matrix,
translate, rotate, scale), instance_geometry with its material binding,
lambert/phong/blinn diffuse colours and the up axis (Z_UP rotated to
Y-up). ``import_collada`` writes a Mitsuba-format scene XML and one OBJ a
mesh, which ``scene/xml_loader.py`` loads. Host-only: ``xml.etree`` and
numpy.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

_NS = "{http://www.collada.org/2005/11/COLLADASchema}"


def _tag(el):
    return el.tag.split("}")[-1]


def _find(el, name):
    return el.find(f"{_NS}{name}") if el is not None else None


def _findall(el, name):
    return el.findall(f"{_NS}{name}") if el is not None else []


def _floats(text):
    return np.asarray([float(x) for x in text.split()], np.float64)


def _ints(text):
    return np.asarray([int(x) for x in text.split()], np.int64)


def _parse_sources(mesh_el):
    """id -> [N, stride] float arrays for all <source> elements."""
    out = {}
    for src in _findall(mesh_el, "source"):
        arr_el = _find(src, "float_array")
        if arr_el is None:
            continue
        data = _floats(arr_el.text or "")
        acc = _find(_find(src, "technique_common"), "accessor")
        stride = int(acc.get("stride", 1)) if acc is not None else 1
        out["#" + src.get("id")] = data.reshape(-1, stride)
    # <vertices> indirection: VERTEX inputs point here.
    for v in _findall(mesh_el, "vertices"):
        for inp in _findall(v, "input"):
            if inp.get("semantic") == "POSITION":
                out["#" + v.get("id")] = out[inp.get("source")]
    return out


def _parse_prim(prim, sources):
    """One <triangles>/<polylist> -> dict(v [F,3,3], n, uv, material)."""
    inputs = []
    max_off = 0
    for inp in _findall(prim, "input"):
        off = int(inp.get("offset", 0))
        inputs.append((inp.get("semantic"), off, inp.get("source")))
        max_off = max(max_off, off)
    stride = max_off + 1
    p_el = _find(prim, "p")
    if p_el is None:
        return None
    idx = _ints(p_el.text or "")

    if _tag(prim) == "polylist":
        vcount = _ints(_find(prim, "vcount").text or "")
        # Triangulate each polygon as a fan.
        tri_rows = []
        pos = 0
        for vc in vcount:
            poly = idx[pos * stride:(pos + vc) * stride].reshape(vc, stride)
            for k in range(1, vc - 1):
                tri_rows.append(np.stack([poly[0], poly[k], poly[k + 1]]))
            pos += vc
        if not tri_rows:
            return None
        corners = np.concatenate(tri_rows, 0)  # [3F, stride]
    else:  # triangles
        corners = idx.reshape(-1, stride)

    f = corners.shape[0] // 3
    out = {"material": prim.get("material"), "v": None, "n": None, "uv": None}
    for sem, off, src in inputs:
        data = sources.get(src)
        if data is None:
            continue
        vals = data[corners[:, off]]
        if sem in ("VERTEX", "POSITION"):
            out["v"] = vals[:, :3].reshape(f, 3, 3)
        elif sem == "NORMAL":
            out["n"] = vals[:, :3].reshape(f, 3, 3)
        elif sem == "TEXCOORD":
            out["uv"] = vals[:, :2].reshape(f, 3, 2)
    return out if out["v"] is not None else None


def _node_transform(node):
    m = np.eye(4)
    for child in node:
        t = _tag(child)
        vals = _floats(child.text or "") if child.text else np.zeros(0)
        if t == "matrix":
            m = m @ vals.reshape(4, 4)
        elif t == "translate":
            tm = np.eye(4)
            tm[:3, 3] = vals[:3]
            m = m @ tm
        elif t == "scale":
            sm = np.diag(np.append(vals[:3], 1.0))
            m = m @ sm
        elif t == "rotate":
            x, y, z, ang = vals[:4]
            a = np.deg2rad(ang)
            axis = np.array([x, y, z])
            n = np.linalg.norm(axis)
            if n > 0:
                axis /= n
                c, s = np.cos(a), np.sin(a)
                x, y, z = axis
                rm = np.eye(4)
                rm[:3, :3] = [
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)],
                ]
                m = m @ rm
    return m


def _material_colors(root):
    """material id -> diffuse rgb (lambert/phong effects)."""
    effects = {}
    for eff in _findall(_find(root, "library_effects"), "effect"):
        rgb = np.array([0.5, 0.5, 0.5])
        for shader in ("lambert", "phong", "blinn"):
            for sh in eff.iter(f"{_NS}{shader}"):
                dif = _find(sh, "diffuse")
                c = _find(dif, "color") if dif is not None else None
                if c is not None:
                    rgb = _floats(c.text)[:3]
        effects["#" + eff.get("id")] = rgb
    mats = {}
    for mat in _findall(_find(root, "library_materials"), "material"):
        inst = _find(mat, "instance_effect")
        rgb = effects.get(inst.get("url"), np.array([0.5, 0.5, 0.5])) \
            if inst is not None else np.array([0.5, 0.5, 0.5])
        mats[mat.get("id")] = rgb
    return mats


def load_dae(path: str):
    """Parse a .dae file. Returns (meshes, materials) where each mesh is
    dict(name, v [F,3,3] world-space, n, uv, material) and materials maps
    material id -> diffuse rgb. Z_UP scenes are rotated to Y-up."""
    root = ET.parse(path).getroot()
    up = _find(_find(root, "asset"), "up_axis")
    up_fix = np.eye(4)
    if up is not None and (up.text or "").strip() == "Z_UP":
        # Z-up -> Y-up: x' = x, y' = z, z' = -y.
        up_fix = np.array([
            [1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1],
        ], np.float64)

    sources_by_geom = {}
    prims_by_geom = {}
    for geom in _findall(_find(root, "library_geometries"), "geometry"):
        mesh_el = _find(geom, "mesh")
        if mesh_el is None:
            continue
        gid = "#" + geom.get("id")
        srcs = _parse_sources(mesh_el)
        prims = []
        for pname in ("triangles", "polylist"):
            for prim in _findall(mesh_el, pname):
                parsed = _parse_prim(prim, srcs)
                if parsed is not None:
                    prims.append(parsed)
        prims_by_geom[gid] = prims
        sources_by_geom[gid] = geom.get("name") or geom.get("id")

    materials = _material_colors(root)

    meshes = []

    def walk(node, parent_m):
        m = parent_m @ _node_transform(node)
        for ig in _findall(node, "instance_geometry"):
            gid = ig.get("url")
            # Material binding: symbol -> target material id.
            binds = {}
            bm = _find(ig, "bind_material")
            tc = _find(bm, "technique_common") if bm is not None else None
            for im in _findall(tc, "instance_material"):
                binds[im.get("symbol")] = im.get("target").lstrip("#")
            for prim in prims_by_geom.get(gid, []):
                v = prim["v"]
                vh = np.concatenate([v, np.ones(v.shape[:-1] + (1,))], -1)
                vw = np.einsum("ij,fkj->fki", up_fix @ m, vh)[..., :3]
                n = prim["n"]
                if n is not None:
                    nm = np.linalg.inv((up_fix @ m)[:3, :3]).T
                    n = np.einsum("ij,fkj->fki", nm, n)
                    n /= np.maximum(
                        np.linalg.norm(n, axis=-1, keepdims=True), 1e-12
                    )
                meshes.append({
                    "name": sources_by_geom.get(gid, "mesh"),
                    "v": vw, "n": n, "uv": prim["uv"],
                    "material": binds.get(prim["material"], prim["material"]),
                })
        for sub in _findall(node, "node"):
            walk(sub, m)

    scenes = _find(root, "library_visual_scenes")
    for vs in _findall(scenes, "visual_scene"):
        for node in _findall(vs, "node"):
            walk(node, np.eye(4))
    return meshes, materials


def _write_obj(path, mesh):
    v = mesh["v"].reshape(-1, 3)
    n = mesh["n"].reshape(-1, 3) if mesh["n"] is not None else None
    uv = mesh["uv"].reshape(-1, 2) if mesh["uv"] is not None else None
    with open(path, "w") as f:
        f.write("# imported from COLLADA by sdmm_tpu\n")
        for p in v:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if n is not None:
            for p in n:
                f.write(f"vn {p[0]} {p[1]} {p[2]}\n")
        if uv is not None:
            for p in uv:
                f.write(f"vt {p[0]} {p[1]}\n")
        for i in range(0, len(v), 3):
            a, b, c = i + 1, i + 2, i + 3
            if n is not None and uv is not None:
                f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
            elif n is not None:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")


def import_collada(dae_path: str, out_xml: str):
    """mtsimport equivalent: .dae -> mitsuba scene XML + OBJ meshes.
    Returns the number of meshes written."""
    meshes, materials = load_dae(dae_path)
    out_dir = os.path.dirname(os.path.abspath(out_xml))
    os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
    lines = ['<scene version="0.6.0">']
    for mid, rgb in sorted(materials.items()):
        lines.append(
            f'    <bsdf type="diffuse" id="{mid}">\n'
            f'        <rgb name="reflectance" '
            f'value="{rgb[0]:.6g} {rgb[1]:.6g} {rgb[2]:.6g}"/>\n'
            "    </bsdf>"
        )
    for i, mesh in enumerate(meshes):
        fname = f"meshes/{i:04d}_{mesh['name']}.obj"
        _write_obj(os.path.join(out_dir, fname), mesh)
        mat = mesh["material"]
        ref = (f'\n        <ref id="{mat}"/>'
               if mat in materials else "")
        lines.append(
            f'    <shape type="obj">\n'
            f'        <string name="filename" value="{fname}"/>{ref}\n'
            "    </shape>"
        )
    lines.append("</scene>")
    with open(out_xml, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(meshes)
