"""Port parity of scene loading: the same scene file, loaded by
sdmm_tpu.scene.xml_loader.load_scene and by sdmm_tpu_torch's, builds array-
equal SceneData fields (every field the port has, the port's own derived
fields aside: textures, env maps and delta lights included) and equal
builder settings (integrator, sample count, seed, sampler, rfilter) and
render configs. One case a loader feature; the files (PNG bitmaps, EXR env
maps among them) are written to tmp_path. Media (a .vol density grid among
them) and dipole subsurface instances load into equal tables; so do the
Irawan cloth (its weave file with $parameters), hair, heightfields and
keyframed motion, which once raised NotImplementedError."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import write_png  # noqa: E402
from torch_parity import (  # noqa: E402
    TEST_WEAVE, irawan_norm_draws, jax_scene_arrays, to_np,
)

from sdmm_tpu.scene import xml_loader as jxml  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.scene import xml_loader as txml  # noqa: E402

torch.set_num_threads(1)

SENSOR = """
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld">
      <lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="16"/>
      <integer name="height" value="12"/></film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><scale x="0.3" y="0.3"/>
      <rotate x="1" angle="90"/><translate y="1.98"/></transform>
    <emitter type="area"><rgb name="radiance" value="20"/></emitter>
  </shape>
"""


def _scene(body, head=SENSOR):
    return f'<scene version="0.6.0">{head}{body}</scene>'


def _obj_text():
    """A quad, a triangle without normals, negative indices and a face
    with normals but no uv."""
    return ("v -1 0 -1\nv 1 0 -1\nv 1 0.5 1\nv -1 0.5 1\nv 0 1.5 0\n"
            "vn 0 1 0\nvn 0 0.8 0.6\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
            "f 1/1/1 2/2/1 3/3/2 4/4/2\nf 1 2 5\nf -5/-4 -4/-3 -1/-1\n"
            "f 1//2 3//2 5//1\n")


def _serialized(meshes):
    """A version-4 .serialized container of (positions, normals, uv,
    faces, double) meshes, with the offset table of its meshes."""
    out, offsets = b"", []
    for i, (pos, nrm, uv, faces, double) in enumerate(meshes):
        flags = (0x1 if nrm is not None else 0) | \
            (0x2 if uv is not None else 0) | (0x2000 if double else 0)
        dt = "<f8" if double else "<f4"
        body = struct.pack("<I", flags) + f"mesh{i}".encode() + b"\0"
        body += struct.pack("<QQ", len(pos), len(faces))
        for arr in (pos, nrm, uv):
            if arr is not None:
                body += np.asarray(arr, dt).tobytes()
        body += np.asarray(faces, "<u4").tobytes()
        offsets.append(len(out))
        out += struct.pack("<hh", 0x041C, 0x0004) + zlib.compress(body)
    return out + struct.pack(f"<{len(offsets)}Q", *offsets) + \
        struct.pack("<I", len(offsets))


def _ply_ascii():
    return ("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
            "property float y\nproperty float z\nproperty float nx\n"
            "property float ny\nproperty float nz\nproperty float u\n"
            "property float v\nelement face 1\n"
            "property list uchar int vertex_indices\nend_header\n"
            "-0.5 0 -0.5 0 1 0 0 0\n0.5 0 -0.5 0 1 0 1 0\n"
            "0.5 0.2 0.5 0 0.98 0.2 1 1\n-0.5 0.2 0.5 0 0.98 0.2 0 1\n"
            "4 0 1 2 3\n")


def _ply_binary():
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 2\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    v = np.array([[0, 0, 0], [0.4, 0, 0], [0.4, 0.4, 0.1], [0, 0.4, 0.1],
                  [0.2, 0.7, 0.3]], "<f4")
    faces = struct.pack("<B4i", 4, 0, 1, 2, 3) + struct.pack("<B3i", 3, 2, 3,
                                                             4)
    return head + v.tobytes() + faces


CASES = {
    "default_var_define_include": dict(
        files={"inc.xml": '<scene version="0.6.0"><bsdf type="diffuse" '
                          'id="inc"><rgb name="reflectance" value="$alb"/>'
                          '</bsdf></scene>'},
        xml=_scene("""
  <default name="alb" value="0.2"/> <default name="depth" value="7"/>
  <default name="inc_file" value="inc.xml"/>
  <include filename="$inc_file"/>
  <integrator type="$integrator"><integer name="maxDepth" value="$depth"/>
  </integrator>
  <shape type="cube"><transform name="toWorld"><scale value="0.4"/>
  </transform><ref id="inc"/></shape>"""),
        overrides={"alb": "0.6", "integrator": "volpath"}),
    "ref_twosided_ior_spectrum": dict(xml=_scene("""
  <integrator type="path"><integer name="maxDepth" value="6"/>
    <integer name="rrDepth" value="3"/></integrator>
  <bsdf type="twosided" id="gold"><bsdf type="conductor">
    <string name="material" value="Au"/></bsdf></bsdf>
  <bsdf type="roughconductor" id="al"><string name="material" value="Al"/>
    <float name="alpha" value="0.3"/>
    <spectrum name="specularReflectance" value="0.9"/></bsdf>
  <bsdf type="dielectric" id="water"><string name="intIOR" value="water"/>
    <string name="extIOR" value="air"/></bsdf>
  <bsdf type="dielectric" id="num"><float name="intIOR" value="1.7"/></bsdf>
  <bsdf type="diffuse" id="hex"><rgb name="reflectance" value="#f80"/></bsdf>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform><ref id="gold"/></shape>
  <shape type="cube"><transform name="toWorld"><translate x="0.5"/>
    <scale value="0.2"/></transform><ref id="al"/></shape>
  <shape type="sphere"><float name="radius" value="0.25"/>
    <ref id="water"/></shape>
  <shape type="rectangle"><ref id="num"/></shape>
  <shape type="rectangle"><transform name="toWorld"><translate z="-1"/>
    </transform><ref id="hex"/></shape>
  <shape type="rectangle"><transform name="toWorld"><translate y="-0.5"/>
    </transform><emitter type="area">
    <spectrum name="radiance" value="400:0, 500:8, 600:15.6, 700:18.4"/>
    </emitter></shape>""")),
    "transform_matrix": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><matrix value="0.3 0.1 0 0.2
    -0.1 0.3 0 1.0 0 0 0.25 -0.3 0 0 0 1"/></transform></shape>""")),
    "transform_translate": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><translate x="0.3" y="0.7"
    z="-0.2"/></transform></shape>""")),
    "transform_scale": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><scale value="0.5"/>
    <scale x="0.5" y="1.5" z="0.8"/></transform></shape>""")),
    "transform_rotate": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    <rotate x="0.3" y="1" z="0.2" angle="37"/></transform></shape>""")),
    "transform_lookat": dict(xml=_scene("""
  <shape type="rectangle"><transform name="toWorld">
    <lookat origin="0.2, 0.5, -0.3" target="1, 1, 1" up="0, 0, 1"/>
    </transform></shape>""")),
    "shape_sphere_disk_cylinder": dict(xml=_scene("""
  <shape type="sphere"><point name="center" x="0.1" y="0.8" z="-0.2"/>
    <float name="radius" value="0.3"/><boolean name="flipNormals"
    value="true"/></shape>
  <shape type="disk"><transform name="toWorld"><scale value="0.4"/>
    <rotate x="1" angle="-90"/></transform></shape>
  <shape type="cylinder"><point name="p0" x="0" y="0" z="0"/>
    <point name="p1" x="0.2" y="1" z="0.1"/><float name="radius"
    value="0.1"/><transform name="toWorld"><translate x="-0.5"/>
    </transform></shape>
  <shape type="torus"/>""")),
    "shape_obj_native": dict(
        files={"mesh.obj": _obj_text()}, xml=_scene("""
  <shape type="obj"><string name="filename" value="mesh.obj"/></shape>
  <shape type="obj"><string name="filename" value="mesh.obj"/>
    <transform name="toWorld"><scale x="0.5" y="0.7" z="0.4"/>
    <translate y="0.3"/></transform>
    <boolean name="flipNormals" value="true"/></shape>
  <shape type="obj"><string name="filename" value="mesh.obj"/>
    <boolean name="faceNormals" value="true"/></shape>""")),
    "shape_serialized": dict(
        files={"m.serialized": _serialized([
            ([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
             [[0, 0, 1]] * 4, [[0, 0], [1, 0], [1, 1], [0, 1]],
             [[0, 1, 2], [0, 2, 3]], False),
            ([[0, 0, 0], [0.5, 0, 0.1], [0.2, 0.5, 0.3], [0.2, 0.5, 0.3]],
             None, None, [[0, 1, 2], [1, 2, 3]], True)])},
        xml=_scene("""
  <shape type="serialized"><string name="filename" value="m.serialized"/>
    <transform name="toWorld"><scale value="0.5"/></transform></shape>
  <shape type="serialized"><string name="filename" value="m.serialized"/>
    <integer name="shapeIndex" value="1"/></shape>
  <shape type="serialized"><string name="filename" value="m.serialized"/>
    <boolean name="faceNormals" value="true"/></shape>""")),
    "shape_ply": dict(
        files={"a.ply": _ply_ascii(), "b.ply": _ply_binary()},
        xml=_scene("""
  <shape type="ply"><string name="filename" value="a.ply"/>
    <boolean name="flipNormals" value="true"/></shape>
  <shape type="ply"><string name="filename" value="b.ply"/>
    <transform name="toWorld"><rotate y="1" angle="30"/></transform>
    </shape>""")),
    "shapegroup_instance": dict(xml=_scene("""
  <bsdf type="conductor" id="cu"/>
  <shape type="shapegroup" id="grp">
    <shape type="cube"><transform name="toWorld"><scale value="0.1"/>
      </transform><ref id="cu"/></shape>
    <shape type="sphere"><float name="radius" value="0.1"/>
      <point name="center" x="0.3" y="0" z="0"/></shape>
  </shape>
  <shape type="instance"><ref id="grp"/><transform name="toWorld">
    <translate y="0.5"/></transform></shape>
  <shape type="instance"><ref id="grp"/><transform name="toWorld">
    <rotate y="1" angle="45"/><translate x="-0.4" y="1"/></transform>
  </shape>""")),
    "constant_environment": dict(xml=_scene("""
  <emitter type="constant"><rgb name="radiance" value="0.3, 0.4, 0.5"/>
  </emitter>
  <shape type="rectangle"/>""")),
    "bitmap texture": dict(files={"x.png": "rgb"}, xml=_scene("""
  <shape type="rectangle"><bsdf type="diffuse"><texture type="bitmap"
    name="reflectance"><string name="filename" value="x.png"/></texture>
  </bsdf></shape>""")),
    "scaled checkerboard": dict(xml=_scene("""
  <shape type="rectangle"><bsdf type="diffuse"><texture type="scale">
    <float name="scale" value="0.7"/><texture type="checkerboard">
    <float name="uscale" value="3"/></texture></texture></bsdf></shape>
  """)),
    "bumpmap": dict(files={"h.png": "grey"}, xml=_scene("""
  <shape type="rectangle"><bsdf type="bumpmap"><texture type="bitmap">
    <string name="filename" value="h.png"/></texture><float name="scale"
    value="0.3"/><bsdf type="roughplastic"/></bsdf></shape>
  <shape type="cube"><transform name="toWorld"><scale value="0.2"/>
    </transform><bsdf type="normalmap"><texture type="bitmap"><string
    name="filename" value="h.png"/></texture><bsdf type="phong"/></bsdf>
  </shape>""")),
    "blendbsdf": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform><bsdf type="blendbsdf"><float name="weight" value="0.3"/>
    <bsdf type="diffuse"><texture type="gridtexture" name="reflectance"/>
    </bsdf><bsdf type="conductor"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="mixturebsdf"><string name="weights"
    value="0.2, 0.5, 0.3"/><bsdf type="ward"/><bsdf type="roughdiffuse"/>
    <bsdf type="difftrans"/></bsdf></shape>
  <shape type="sphere"><float name="radius" value="0.2"/><bsdf type="mask">
    <rgb name="opacity" value="0.6"/><bsdf type="hk"/></bsdf></shape>""")),
    "coating": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform><bsdf type="coating"><bsdf type="diffuse"><texture
    type="wireframe" name="reflectance"/></bsdf></bsdf></shape>
  <shape type="sphere"><float name="radius" value="0.2"/><bsdf
    type="roughcoating"><float name="alpha" value="0.2"/><bsdf
    type="roughdielectric"><texture type="curvature"
    name="specularTransmittance"/></bsdf></bsdf></shape>""")),
    "roughplastic": dict(xml=_scene("""
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform><bsdf type="roughplastic"><float name="alpha" value="0.2"/>
    <texture type="vertexcolors" name="diffuseReflectance"/></bsdf>
  </shape>
  <shape type="rectangle"><bsdf type="plastic"/></shape>
  <shape type="rectangle"><transform name="toWorld"><translate z="-1"/>
    </transform><bsdf type="thindielectric"/></shape>""")),
    "point": dict(xml=_scene("""
  <emitter type="point"><point name="position" x="0" y="1" z="0"/>
    <rgb name="intensity" value="3"/></emitter>
  <emitter type="collimated"><transform name="toWorld"><translate
    y="1.5"/></transform></emitter>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform></shape>""")),
    "spot": dict(xml=_scene("""
  <emitter type="spot"><transform name="toWorld"><lookat origin="0, 1.5, 0"
    target="0, 0, 0" up="0, 0, 1"/></transform><float name="cutoffAngle" value="25"/>
    </emitter>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform></shape>""")),
    "directional": dict(xml=_scene("""
  <emitter type="directional"><vector name="direction" x="0.2" y="-1"
    z="0.1"/><rgb name="irradiance" value="2"/></emitter>
  <emitter type="directional"/>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform></shape>""")),
    "envmap": dict(files={"sky.exr": "exr"}, xml=_scene("""
  <emitter type="envmap"><string name="filename" value="sky.exr"/>
    <float name="scale" value="2"/><transform name="toWorld"><rotate
    y="1" angle="30"/></transform></emitter>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform></shape>""")),
    "medium scene-level": dict(xml=_scene("""
      <medium type="homogeneous" id="fog">
        <rgb name="sigmaT" value="0.1, 0.2, 0.3"/>
        <rgb name="albedo" value="0.8"/>
        <phase type="hg"><float name="g" value="0.3"/></phase></medium>
      <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
        </transform></shape>""")),
    "medium interior sigmaS sigmaA": dict(xml=_scene("""
      <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
        </transform><bsdf type="dielectric"/>
        <medium type="homogeneous" name="interior">
          <rgb name="sigmaS" value="1, 2, 3"/><rgb name="sigmaA" value="0.5"/>
          <phase type="hg"><float name="g" value="-0.4"/></phase></medium>
      </shape>
      <shape type="sphere"><float name="radius" value="0.2"/>
        <medium type="homogeneous" name="interior">
          <rgb name="sigmaT" value="2"/></medium></shape>""")),
    "medium heterogeneous": dict(files={"d.vol": "vol"}, xml=_scene("""
      <shape type="sphere"><float name="radius" value="0.4"/>
        <bsdf type="dielectric"/>
        <medium type="heterogeneous" name="interior">
          <volume name="density" type="gridvolume">
            <string name="filename" value="d.vol"/></volume>
          <float name="scale" value="2.5"/><rgb name="albedo" value="0.9"/>
          <phase type="hg"><float name="g" value="0.2"/></phase></medium>
      </shape>""")),
    "subsurface dipole": dict(xml=_scene("""
      <shape type="sphere"><float name="radius" value="0.3"/>
        <subsurface type="dipole"><string name="material" value="marble"/>
          <float name="scale" value="0.01"/></subsurface></shape>
      <shape type="cube"><transform name="toWorld"><scale value="0.2"/>
        </transform><subsurface type="dipole">
          <rgb name="sigmaS" value="1, 2, 3"/><rgb name="sigmaA" value="0.1"/>
          <float name="intIOR" value="1.4"/>
          <integer name="irrSamples" value="8"/></subsurface></shape>""")),
    "shapegroup medium": dict(xml=_scene("""
      <shape type="shapegroup" id="g"><shape type="cube">
        <medium type="homogeneous" name="interior">
          <rgb name="sigmaT" value="0.7"/></medium></shape></shape>
      <shape type="instance"><ref id="g"/><transform name="toWorld">
        <scale value="0.2"/><translate x="0.4"/></transform></shape>""")),
    "sunsky": dict(xml=_scene("""
  <emitter type="sunsky"><integer name="resolution" value="32"/>
    <float name="turbidity" value="4"/></emitter>
  <emitter type="point"><point name="position" x="0" y="1" z="0"/>
    </emitter>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    </transform></shape>""")),
}


def _write(tmp_path, case):
    rs = np.random.RandomState(3)
    for name, text in case.get("files", {}).items():
        if name.endswith(".png"):  # a bitmap of random texels
            write_png(tmp_path / name, rs.randint(
                0, 256, (12, 20, 3) if text == "rgb" else (9, 7)))
            continue
        if name.endswith(".vol"):  # a density grid over its own bounds
            from sdmm_tpu_torch.scene.volume import save_vol

            save_vol(str(tmp_path / name), rs.rand(5, 6, 7),
                     [-0.4, -0.4, -0.4], [0.4, 0.4, 0.4])
            continue
        if name.endswith(".exr"):
            from sdmm_tpu_torch.utils.exr import write_exr

            write_exr(str(tmp_path / name),
                      rs.rand(16, 32, 3).astype(np.float32) * 4.0)
            continue
        mode = "wb" if isinstance(text, bytes) else "w"
        with open(tmp_path / name, mode) as f:
            f.write(text)
    path = tmp_path / "scene.xml"
    path.write_text(case["xml"])
    return str(path)


def _assert_same_settings(jb, tb):
    assert (tb.sample_count, tb.seed, tb.sampler, tb.rfilter) == (
        jb.sample_count, jb.seed, jb.sampler, jb.rfilter)
    assert tb.integrator.keys() == jb.integrator.keys()
    for k, v in jb.integrator.items():
        np.testing.assert_array_equal(tb.integrator[k], v, err_msg=k)


def _assert_same_scene(js, jcfg, ts, tcfg):
    ja = jax_scene_arrays(js)
    for name in tscene.SceneData._fields:
        if name in tscene.PORT_FIELDS:  # the reference has no such array
            continue
        np.testing.assert_array_equal(to_np(getattr(ts, name)), ja[name],
                                      err_msg=name)
    assert (tcfg.width, tcfg.height, tcfg.max_depth, tcfg.rr_depth,
            tcfg.fov_axis, tcfg.bsdf_types, tcfg.has_medium,
            tcfg.has_hetero, tcfg.has_sss) == (
        jcfg.width, jcfg.height, jcfg.max_depth, jcfg.rr_depth,
        jcfg.fov_axis, jcfg.bsdf_types, jcfg.has_medium, jcfg.has_hetero,
        jcfg.has_sss)
    for a, b in zip(tcfg.sss, jcfg.sss):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaders_build_equal_scenes(case, tmp_path):
    c = CASES[case]
    path = _write(tmp_path, c)
    overrides = c.get("overrides", {})
    tb = txml.load_scene(path, dict(overrides))
    jb = jxml.load_scene(path, dict(overrides))
    _assert_same_settings(jb, tb)
    js, jcfg = jb.build()
    ts, tcfg = tb.build(device="cpu")
    _assert_same_scene(js, jcfg, ts, tcfg)
    assert ts.tri_v0.shape[0] > 2  # the case's shapes were built


@pytest.mark.parametrize("kw", [
    {}, {"face_normals": True}, {"flip_normals": True},
    {"to_world": np.diag([0.5, 2.0, 1.0, 1.0]), "flip_normals": True}],
    ids=["plain", "face_normals", "flip", "scaled_flip"])
def test_obj_python_parser_matches_native_and_reference(kw, tmp_path,
                                                        monkeypatch):
    """The plain twin of the native OBJ parser: the port's Python route
    gives the native route's soup, and the reference's Python route's."""
    from sdmm_tpu.scene import shapes as jshapes

    path = str(tmp_path / "mesh.obj")
    with open(path, "w") as f:
        f.write(_obj_text())
    nat = tshapes.load_obj(path, **kw).concat()
    py = tshapes.load_obj(path, native=False, **kw).concat()
    monkeypatch.setenv("SDMM_TPU_NO_NATIVE", "1")
    ref = jshapes.load_obj(path, **kw).concat()[:3]
    assert len(py[0]) == 5
    for a, b, c in zip(nat, py, ref):
        np.testing.assert_array_equal(b, c)
        if "to_world" in kw:  # normals renormalised in another order
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
        else:
            np.testing.assert_array_equal(a, b)


def _hair_text():
    """Two fibers in the hair text format, the second with a straight run
    that the angle threshold thins."""
    pts = [[0.1 * i, 1.5 - 0.1 * i, 0.02 * (i % 2)] for i in range(6)]
    pts2 = [[0.3, 1.4 - 0.1 * i, 0.0] for i in range(5)]
    return "\n".join(" ".join(str(x) for x in p) for p in pts) + "\n\n" + \
        "\n".join(" ".join(str(x) for x in p) for p in pts2) + "\n"


def _height_exr():
    from sdmm_tpu_torch.utils.exr import write_exr

    path = "h.exr"
    g = np.linspace(0.0, 1.0, 6 * 5).reshape(5, 6) ** 2
    return path, lambda d: write_exr(os.path.join(d, path), np.repeat(
        g[..., None], 3, -1).astype(np.float32))


GEOMETRY = {
    "irawan": ('<shape type="rectangle"><bsdf type="irawan"><string '
               'name="filename" value="w.weave"/><float name="alpha" '
               'value="0.2"/><float name="ks" value="0.7"/><float '
               'name="repeatU" value="4"/><float name="repeatV" value="3"/>'
               '</bsdf></shape>', {"w.weave": TEST_WEAVE}),
    "hair": ('<shape type="hair"><string name="filename" value="h.hair"/>'
             '<float name="radius" value="0.01"/><float name="angleThreshold"'
             ' value="5"/><transform name="toWorld"><translate x="0.2"/>'
             '</transform></shape>', {"h.hair": _hair_text()}),
    "heightfield": ('<shape type="heightfield"><texture type="bitmap">'
                    '<string name="filename" value="h.exr"/></texture><float '
                    'name="scale" value="0.3"/><boolean name="shadingNormals"'
                    ' value="false"/><transform name="toWorld"><rotate x="1" '
                    'angle="-90"/></transform></shape>', {}),
    "motion": ('<shape type="cube"><animation name="toWorld"><transform '
               'time="0"><scale value="0.2"/></transform><transform time='
               '"0.5"><translate x="0.3"/></transform><transform time="1">'
               '<scale value="0.2"/><rotate y="1" angle="30"/><translate '
               'x="0.5" y="0.2"/></transform></animation></shape><shape '
               'type="sphere"><float name="radius" value="0.2"/></shape>', {}),
}


@pytest.mark.parametrize("feature", sorted(GEOMETRY))
def test_unported_features_raise_at_load(feature, tmp_path):
    """The features that once raised (irawan, hair, heightfield, keyframed
    motion) now load: the same XML through both loaders builds equal
    SceneData, field for field. Irawan's specular normalisation is a
    Monte Carlo estimate: the port's own draws give its own constant, and
    on the reference's draws the port gives the reference's (rtol 1e-5)."""
    from sdmm_tpu_torch.bsdf import irawan as tirawan

    body, files = GEOMETRY[feature]
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    if feature == "heightfield":
        _height_exr()[1](str(tmp_path))
    path = tmp_path / "scene.xml"
    path.write_text(_scene(body))
    tb = txml.load_scene(str(path))
    jb = jxml.load_scene(str(path))
    _assert_same_settings(jb, tb)
    js, jcfg = jb.build()
    ts, tcfg = tb.build(device="cpu")
    if feature == "irawan":
        tables = {k: getattr(ts, f"iw_{k}") for k in
                  ("pattern", "yarns", "kd", "ks", "consts")}
        norm = tirawan.specular_normalization(
            tables, *(torch.tensor(x) for x in irawan_norm_draws()))
        want = np.asarray(js.iw_consts)
        np.testing.assert_allclose(norm, want[8], rtol=1e-5)
        assert 0.0 < float(ts.iw_consts[8]) < np.inf
        ts = ts._replace(iw_consts=torch.tensor(want))
    _assert_same_scene(js, jcfg, ts, tcfg)
    counts = {"irawan": 2, "hair": 8 * 4 + 8 * 1, "heightfield": 2 * 4 * 8,
              "motion": 12}
    assert ts.tri_v0.shape[0] > counts[feature]
    if feature == "motion":
        assert ts.mot_m0.shape == (1, 4, 4) and (ts.tri_mot >= 0).sum() == 12
