"""Port parity of the geometry half of scene loading, on the same numpy
inputs and files:

- load_hair in both file formats (text and BINARY_HAIR), with and without
  ``reduction`` (the reference's default_rng(0) draw) and a toWorld:
  array-equal soups; load_height_data from an EXR and a PNG (the port's
  own decoders; the reference reads PNG through PIL) and make_heightfield
  with and without shading normals, flipped, transformed and with
  power-of-two resampling: rtol 1e-12 on float64;
- keyframed motion through SceneBuilder.build (mot_m0, mot_m1, tri_mot)
  equal; load_dae and import_collada on a COLLADA file with polylists,
  normals, texture coordinates, a nested transform stack, Z_UP and bound
  materials: the same arrays, the same XML and OBJ text;
- generate_rays in its four modes (perspective, thinlens, orthographic,
  spherical) on the same pixels and lens_uv: rtol 1e-5.
"""

import os
import struct
import sys
import types

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import write_png  # noqa: E402
from torch_parity import compose, make_box, to_np  # noqa: E402

from sdmm_tpu.scene import collada as jcollada  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import sensor as jsensor  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.scene import collada as tcollada  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import sensor as tsensor  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.utils.exr import write_exr  # noqa: E402

torch.set_num_threads(1)


def _fibers(seed=0, n=12):
    """Fibers of 2-9 vertices: wavy ones, a straight run (interior
    vertices dropped by the angle threshold), a repeated vertex."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = 2 + i % 8
        t = np.arange(k)[:, None]
        p = rs.rand(3) + np.concatenate(
            [0.05 * np.sin(t * (1.0 + i)), -0.1 * t, 0.05 * np.cos(t * 0.7)],
            -1)
        if i == 3:
            p = rs.rand(3) + t * np.array([0.0, -0.1, 0.0])  # collinear
        if i == 5:
            p[2] = p[1]  # a zero-length segment
        out.append(p.astype(np.float32).astype(np.float64))
    return out


def _write_hair(tmp, fibers):
    text = tmp / "h.hair"
    lines = []
    for f in fibers:
        lines += ["%.9g %.9g %.9g" % tuple(p) for p in f] + [""]
    lines += ["1 2 3", ""]  # a fiber of one vertex: dropped
    text.write_text("\n".join(lines))
    binary = tmp / "h.bin"
    rows = []
    for f in fibers:
        rows += list(f) + [np.array([np.inf, 0, 0])]
    data = np.asarray(rows, "<f4")
    binary.write_bytes(b"BINARY_HAIR" + struct.pack("<I", len(data))
                       + data.tobytes())
    return str(text), str(binary)


def _assert_soups_equal(a, b, rtol=0.0):
    for x, y in zip(a.concat(), b.concat()):
        if rtol:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-14)
        else:
            np.testing.assert_array_equal(x, y)
    assert a.has_colors == b.has_colors


def test_hair_and_heightfields_match_reference(tmp_path):
    text, binary = _write_hair(tmp_path, _fibers())
    tw = compose([0.1, 0.2, 0.3], [1.0, 2.0, 1.0], rx=20.0)
    for path in (text, binary):
        for kw in ({}, {"reduction": 0.5, "to_world": tw},
                   {"angle_threshold_deg": 10.0, "n_sides": 6}):
            t = tshapes.load_hair(path, radius=0.01, **kw)
            j = jshapes.load_hair(path, radius=0.01, **kw)
            _assert_soups_equal(t, j)
            assert len(t.concat()[0]) > 0
    full = len(tshapes.load_hair(text).concat()[0])
    assert 0 < len(tshapes.load_hair(text, reduction=0.5).concat()[0]) < full

    rs = np.random.RandomState(1)
    grid = rs.rand(5, 7)
    write_exr(str(tmp_path / "h.exr"),
              np.stack([grid, 0.5 * grid, grid ** 2], -1).astype(np.float32))
    write_png(str(tmp_path / "h.png"),
              (np.stack([grid, grid[::-1], grid], -1) * 255).round())
    for name in ("h.exr", "h.png"):
        path = str(tmp_path / name)
        np.testing.assert_allclose(tshapes.load_height_data(path, 0.3),
                                   jshapes.load_height_data(path, 0.3),
                                   rtol=1e-12)
    for data, kw in ((grid, {}), (grid, {"shading_normals": False}),
                     (rs.rand(9, 17), {"flip_normals": True,
                                       "to_world": tw}),
                     (rs.rand(3, 3), {})):
        t = tshapes.make_heightfield(data, **kw)
        j = jshapes.make_heightfield(data, **kw)
        _assert_soups_equal(t, j, rtol=1e-12)
    # 5x7 resamples to 5x9: 4x8 cells of two triangles.
    assert len(tshapes.make_heightfield(grid).concat()[0]) == 2 * 4 * 8
    for n in (2, 3, 5, 6, 9, 100):
        assert tshapes._round_pow2_plus_1(n) == jshapes._round_pow2_plus_1(n)


DAE = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Z_UP</up_axis></asset>
  <library_effects>
    <effect id="red-fx"><profile_COMMON><technique sid="t"><lambert>
      <diffuse><color>0.8 0.1 0.1 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
    <effect id="blue-fx"><profile_COMMON><technique sid="t"><phong>
      <diffuse><color>0.1 0.2 0.7 1</color></diffuse></phong>
    </technique></profile_COMMON></effect>
  </library_effects>
  <library_materials>
    <material id="red"><instance_effect url="#red-fx"/></material>
    <material id="blue"><instance_effect url="#blue-fx"/></material>
  </library_materials>
  <library_geometries>
    <geometry id="quad" name="quad"><mesh>
      <source id="qp"><float_array count="15">0 0 0 1 0 0 1 1 0 0 1 0
        0.5 1.5 0</float_array><technique_common><accessor stride="3"/>
        </technique_common></source>
      <source id="qn"><float_array count="6">0 0 1 0 0.6 0.8</float_array>
        <technique_common><accessor stride="3"/></technique_common></source>
      <source id="qt"><float_array count="8">0 0 1 0 1 1 0 1</float_array>
        <technique_common><accessor stride="2"/></technique_common></source>
      <vertices id="qv"><input semantic="POSITION" source="#qp"/></vertices>
      <polylist count="2" material="m0">
        <input semantic="VERTEX" source="#qv" offset="0"/>
        <input semantic="NORMAL" source="#qn" offset="1"/>
        <input semantic="TEXCOORD" source="#qt" offset="2"/>
        <vcount>4 3</vcount>
        <p>0 0 0 1 0 1 2 1 2 3 0 3  3 1 3 2 1 2 4 0 0</p>
      </polylist>
    </mesh></geometry>
    <geometry id="tri" name="tri"><mesh>
      <source id="tp"><float_array count="9">0 0 0 2 0 0 0 0 2</float_array>
        <technique_common><accessor stride="3"/></technique_common></source>
      <vertices id="tv"><input semantic="POSITION" source="#tp"/></vertices>
      <triangles count="1" material="m1">
        <input semantic="VERTEX" source="#tv" offset="0"/><p>0 1 2</p>
      </triangles>
    </mesh></geometry>
  </library_geometries>
  <library_visual_scenes><visual_scene id="s">
    <node id="a"><translate>1 2 3</translate><rotate>0 0 1 30</rotate>
      <scale>2 1 1</scale>
      <instance_geometry url="#quad"><bind_material><technique_common>
        <instance_material symbol="m0" target="#red"/></technique_common>
      </bind_material></instance_geometry>
      <node id="b"><matrix>1 0 0 0.5 0 1 0 0 0 0 1 0 0 0 0 1</matrix>
        <instance_geometry url="#tri"><bind_material><technique_common>
          <instance_material symbol="m1" target="#blue"/>
        </technique_common></bind_material></instance_geometry>
      </node>
    </node>
  </visual_scene></library_visual_scenes>
</COLLADA>
"""


def test_motion_and_collada_match_reference(tmp_path):
    m0 = compose([0.2, 0.3, 0.1], [0.2, 0.2, 0.2], ry=10.0)
    m1 = compose([0.5, 0.3, 0.1], [0.2, 0.2, 0.2], ry=40.0)
    built = []
    for mod, shapes in ((jscene, jshapes), (tscene, tshapes)):
        b = make_box(mod, shapes, 8, 8)
        b.add_shape(shapes.make_cube(m0), 0, motion=(m0, m1))
        b.add_shape(shapes.make_cube(compose([-0.4, 0.2, 0], [0.1] * 3)), 1)
        b.add_shape(shapes.make_rectangle(m1), 2, motion=(m1, m0))
        built.append(b.build() if mod is jscene
                     else b.build(device="cpu"))
    (js, _), (ts, _) = built
    for name in ("mot_m0", "mot_m1", "tri_mot"):
        np.testing.assert_array_equal(to_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert sorted(set(to_np(ts.tri_mot).tolist())) == [-1, 0, 1]
    static, _ = make_box(tscene, tshapes, 8, 8).build(device="cpu")
    assert static.mot_m0.shape == (1, 4, 4) and (static.tri_mot < 0).all()

    dae = tmp_path / "scene.dae"
    dae.write_text(DAE)
    tm, tmat = tcollada.load_dae(str(dae))
    jm, jmat = jcollada.load_dae(str(dae))
    assert tmat.keys() == jmat.keys() == {"red", "blue"}
    for k in tmat:
        np.testing.assert_array_equal(tmat[k], jmat[k])
    assert len(tm) == len(jm) == 2
    for a, b in zip(tm, jm):
        assert (a["name"], a["material"]) == (b["name"], b["material"])
        for k in ("v", "n", "uv"):
            assert (a[k] is None) == (b[k] is None), k
            if a[k] is not None:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tm[0]["v"].shape == (3, 3, 3)  # a quad and a triangle, as fans
    outs = []
    for mod, sub in ((tcollada, "t"), (jcollada, "j")):
        (tmp_path / sub).mkdir()
        xml = tmp_path / sub / "out.xml"
        assert mod.import_collada(str(dae), str(xml)) == 2
        files = sorted(p.relative_to(tmp_path / sub)
                       for p in (tmp_path / sub).rglob("*") if p.is_file())
        outs.append({str(p): (tmp_path / sub / p).read_text()
                     for p in files})
    assert outs[0] == outs[1]
    assert len(outs[0]) == 3


def _camera(mod_array, fov_deg=40.0):
    cam = compose([0.3, 1.0, 4.0], [1.0, 1.0, 1.0], rx=-10.0, ry=170.0)
    return types.SimpleNamespace(
        cam_to_world=mod_array(cam.astype(np.float32)),
        cam_tan_half_fov=mod_array(np.float32(np.tan(np.deg2rad(fov_deg)
                                                     / 2))))


def test_sensor_modes_match_reference():
    rs = np.random.RandomState(2)
    n, w, h = 4096, 48, 32
    pix = (rs.rand(n, 2) * [w, h]).astype(np.float32)
    lens = rs.rand(n, 2).astype(np.float32)
    ts = _camera(torch.as_tensor)
    js = _camera(jnp.asarray)
    modes = [("perspective", {}), ("spherical", {}),
             ("orthographic", {"ortho_scale": 1.7}),
             ("thinlens", {"aperture": 0.2, "focus_dist": 3.5}),
             ("thinlens", {"aperture": 0.0})]
    for mode, kw in modes:
        for axis in ("x", "y"):
            got = tsensor.generate_rays(ts, torch.as_tensor(pix), w, h, axis,
                                        sensor_type=mode,
                                        lens_uv=torch.as_tensor(lens), **kw)
            want = jsensor.generate_rays(js, jnp.asarray(pix), w, h, axis,
                                         sensor_type=mode,
                                         lens_uv=jnp.asarray(lens), **kw)
            for a, b, what in zip(got, want, ("origin", "direction")):
                np.testing.assert_allclose(
                    to_np(a), np.broadcast_to(np.asarray(b), a.shape),
                    rtol=1e-5, atol=1e-6, err_msg=f"{mode} {axis} {what}")
            assert torch.allclose(torch.linalg.vector_norm(got[1], dim=-1),
                                  torch.ones(n))
