"""Scene container: host-side builder → device SoA tensors (port of
sdmm_tpu/scene/scene.py without motion, the Irawan weave tables and the
reference's BVH and kernel-layout copies).

``SceneData`` keeps the triangle arrays with their mesh-attribute tables
(vertex colours, edge heights), the BSDF table of every type but Irawan
with its texture, bump and container columns, the bitmap texture stack and
the procedural texture rows, the emitter radiance table with the
power-weighted emissive-triangle distribution, the environment (a constant
or an equirect map with its NEE tables), the delta lights (point, spot,
directional, collimated), the media table (homogeneous rows and grid
densities, each triangle's interior and exterior medium), the dipole
subsurface instances, the camera, the scene AABB (the guiding
normalization domain) and the triangle clusters of the cluster-cull
intersector (``render/clas.py``, ``ops/clas_cull.py``): the reference's
arrays, plus two that only the port's kernel reads (``PORT_FIELDS``),
derived from them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..core.aabb import AABB
from ..core.device import resolve_device
from ..core.spectrum import luminance
from .shapes import TriSoup

BSDF_DIFFUSE = 0
BSDF_CONDUCTOR = 1  # smooth, delta
BSDF_DIELECTRIC = 2  # smooth, delta
BSDF_ROUGHCONDUCTOR = 3
BSDF_PHONG = 4
BSDF_ROUGHPLASTIC = 5
BSDF_ROUGHDIELECTRIC = 6
BSDF_NULL = 7
BSDF_PLASTIC = 8
BSDF_WARD = 9  # anisotropic glossy
BSDF_BLEND = 10  # two-child mixture
BSDF_MASK = 11  # opacity mask over a child
BSDF_ROUGHDIFFUSE = 12  # Oren-Nayar
BSDF_DIFFTRANS = 13  # diffuse transmitter
BSDF_COATING = 14  # dielectric layer over a child
BSDF_HK = 15  # Hanrahan-Krueger single-scattering slab
BSDF_IRAWAN = 16  # Irawan-Marschner woven cloth: not ported (ROADMAP A9)
BSDF_THINDIELECTRIC = 17  # thin slab, no refraction

# Procedural texture kinds.
PROC_CHECKERBOARD = 0
PROC_GRID = 1
PROC_MESHATTR = 2  # vertexcolors / curvature baked to vertex colours
PROC_WIREFRAME = 3

SUPPORTED_BSDFS = tuple(t for t in range(18) if t != BSDF_IRAWAN)


class SceneData(NamedTuple):
    """Device-side scene; every field is a tensor."""

    tri_v0: torch.Tensor  # [T, 3]
    tri_e1: torch.Tensor  # [T, 3]
    tri_e2: torch.Tensor  # [T, 3]
    tri_ng: torch.Tensor  # [T, 3] geometric normal
    tri_ns: torch.Tensor  # [T, 3, 3] per-vertex shading normals
    tri_uv: torch.Tensor  # [T, 3, 2]
    tri_bsdf: torch.Tensor  # [T] int32
    tri_emitter: torch.Tensor  # [T] int32, -1 if not emissive
    bsdf_type: torch.Tensor  # [B] int32
    bsdf_albedo: torch.Tensor  # [B, 3]
    bsdf_specular: torch.Tensor  # [B, 3]
    bsdf_alpha: torch.Tensor  # [B]
    bsdf_eta: torch.Tensor  # [B]
    bsdf_k: torch.Tensor  # [B, 3]
    bsdf_exponent: torch.Tensor  # [B] phong exponent
    bsdf_tex: torch.Tensor  # [B] int32 albedo texture: -1 none, >= 0 bitmap,
    # <= -2 procedural row -(id + 2)
    bsdf_alpha_v: torch.Tensor  # [B] second roughness axis (ward)
    bsdf_bump: torch.Tensor  # [B] int32 height texture (-1 none; <= -2 a
    # normal map -(id + 2))
    bsdf_bump_scale: torch.Tensor  # [B]
    bsdf_child0: torch.Tensor  # [B] int32 child (blend/mask/coating; -1)
    bsdf_child1: torch.Tensor  # [B] int32 second child (blend)
    bsdf_weight: torch.Tensor  # [B] blend factor toward child1
    textures: torch.Tensor  # [NT, R, R, 3] resampled bitmap stack
    # Procedural rows [kind, c0(3), c1(3), uscale, vscale, uoffset,
    # voffset, line_width, step_width]; [0, 13] = none.
    proc_tex: torch.Tensor  # [NP, 13]
    tri_vc: torch.Tensor  # [T, 9] per-corner colours ([0, 9] = none)
    tri_eh: torch.Tensor  # [T, 3] per-edge interior heights ([0, 3] = none)
    emitter_radiance: torch.Tensor  # [E, 3]
    em_tri_idx: torch.Tensor  # [M] int32 triangle ids of emissive tris
    em_tri_cdf: torch.Tensor  # [M] CDF over emissive tris (by power)
    em_tri_pdf: torch.Tensor  # [M] discrete probability of each tri
    em_tri_area: torch.Tensor  # [M]
    env_radiance: torch.Tensor  # [3] constant environment / env map scale
    env_map: torch.Tensor  # [He, We, 3] equirect map ([1, 1, 3] zeros = none)
    env_to_world: torch.Tensor  # [3, 3] env map orientation
    # Env-map NEE tables: the row marginal CDF, each row's column CDF and
    # each pixel's solid-angle pdf.
    env_row_cdf: torch.Tensor  # [He]
    env_col_cdf: torch.Tensor  # [He, We]
    env_pdf: torch.Tensor  # [He, We]
    env_select_prob: torch.Tensor  # [] NEE share routed to the env map
    # Delta lights, kind 0 point, 1 spot, 2 directional (pos holds the
    # direction toward the light), 3 collimated.
    pt_pos: torch.Tensor  # [P, 3]
    pt_intensity: torch.Tensor  # [P, 3] intensity, irradiance or power
    pt_kind: torch.Tensor  # [P] int32
    pt_dir: torch.Tensor  # [P, 3] spot axis / beam direction
    pt_cutoff_cos: torch.Tensor  # [P]
    pt_beam_cos: torch.Tensor  # [P]
    pt_cdf: torch.Tensor  # [P] selection CDF by power
    pt_select_prob: torch.Tensor  # [] NEE share routed to delta lights
    # Media table, row 0 vacuum; rays carry a medium id that switches at
    # the boundaries of a shape with an interior medium.
    med_sigma_t: torch.Tensor  # [M, 3] extinction
    med_albedo: torch.Tensor  # [M, 3] single-scattering albedo
    med_g: torch.Tensor  # [M] Henyey-Greenstein anisotropy
    tri_medium: torch.Tensor  # [T] int32 interior medium (0 = vacuum)
    tri_medium_ext: torch.Tensor  # [T] int32 exterior medium
    ambient_med: torch.Tensor  # [] int32 the camera's medium
    # Heterogeneous rows: density grid (-1 = homogeneous), its bounds and
    # the majorant density of delta tracking.
    med_vol: torch.Tensor  # [M] int32 index into volumes
    med_vol_lo: torch.Tensor  # [M, 3]
    med_vol_inv_ext: torch.Tensor  # [M, 3]
    med_majorant: torch.Tensor  # [M]
    volumes: torch.Tensor  # [NV, R, R, R] density grids ([1,1,1,1] = none)
    cam_to_world: torch.Tensor  # [4, 4]
    cam_tan_half_fov: torch.Tensor  # []
    aabb_lo: torch.Tensor  # [3]
    aabb_hi: torch.Tensor  # [3]
    # Morton-ordered triangle clusters (render/clas.build_clusters).
    clas_ids: torch.Tensor  # [C, Tc] int32 original tri ids (-1 pad)
    clas_woop: torch.Tensor  # [C, 12, Tc] Woop rows (ops/clas_cull)
    clas_aabb: torch.Tensor  # [8, Cp] padded AABB table (ops/clas_cull)
    # Dipole subsurface scattering: the instance of each triangle, each
    # instance's relative IOR and the baked per-corner exitance
    # (render/subsurface.bake_subsurface fills sss_M).
    tri_sss: torch.Tensor  # [T] int32 (-1 = none)
    sss_eta: torch.Tensor  # [S]
    sss_M: torch.Tensor  # [T, 3, 3]
    # The port's own: derived from the clusters above by scene_from_numpy.
    clas_tree: torch.Tensor  # [2P, 8] tree over the boxes (build_tree)
    clas_woop_slot: torch.Tensor  # [C, Tc, 12] Woop rows by slot (slot_rows)


# Fields the reference's SceneData does not have.
PORT_FIELDS = ("clas_tree", "clas_woop_slot")


_INT_FIELDS = ("tri_bsdf", "tri_emitter", "bsdf_type", "bsdf_tex",
               "bsdf_bump", "bsdf_child0", "bsdf_child1", "em_tri_idx",
               "pt_kind", "clas_ids", "tri_medium", "tri_medium_ext",
               "ambient_med", "med_vol", "tri_sss")


def scene_from_numpy(arrays: dict, device="cuda") -> SceneData:
    """SceneData on ``device`` from a dict of arrays keyed by field name
    (float32/int32). The ``PORT_FIELDS`` are derived from the clusters and
    extra keys are ignored, so the arrays of the reference package's
    SceneData build the same scene."""
    # Imported here: ops reaches this module through render.volpath.
    from ..ops.clas_cull import build_tree, slot_rows

    device = resolve_device(device)
    arrays = dict(arrays)
    woop = np.asarray(arrays["clas_woop"], np.float32)
    arrays["clas_tree"] = build_tree(np.asarray(arrays["clas_aabb"],
                                                np.float32), woop.shape[0])
    arrays["clas_woop_slot"] = slot_rows(woop)
    out = {}
    for name in SceneData._fields:
        a = np.asarray(arrays[name])
        dt = np.int32 if name in _INT_FIELDS else np.float32
        out[name] = torch.as_tensor(a.astype(dt), device=device)
    return SceneData(**out)


def scene_to(scene: SceneData, device) -> SceneData:
    return SceneData(*(t.to(device) for t in scene))


@dataclass
class RenderConfig:
    """Static render parameters."""

    width: int = 256
    height: int = 256
    max_depth: int = 10
    rr_depth: int = 10
    fov_axis: str = "x"
    bsdf_types: tuple = ()  # BSDF type codes present in the scene
    has_bump: bool = False  # any bump or normal map
    has_medium: bool = False  # any participating medium
    has_hetero: bool = False  # any grid-density medium
    has_sss: bool = False  # any dipole subsurface instance on a triangle
    sss: tuple = ()  # the instances' dipole parameters
    sss_baked: bool = False  # set by whoever keeps a baked scene


@dataclass
class SceneBuilder:
    soups: list = field(default_factory=list)
    bsdfs: list[dict] = field(default_factory=list)
    textures: list[np.ndarray] = field(default_factory=list)  # [R, R, 3]
    proc_textures: list[dict] = field(default_factory=list)
    texture_res: int = 256
    bsdf_ids: dict = field(default_factory=dict)
    emitters: list[np.ndarray] = field(default_factory=list)
    point_lights: list[dict] = field(default_factory=list)
    env_radiance: np.ndarray | None = None
    env_map: np.ndarray | None = None  # [He, We, 3]
    env_to_world: np.ndarray = field(default_factory=lambda: np.eye(3))
    medium: dict | None = None  # scene-level {"sigma_t", "albedo", "g"}
    subsurfaces: list = field(default_factory=list)  # dipole instances
    media: list = field(default_factory=list)  # per-shape medium rows
    cam_to_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    fov_deg: float = 45.0
    fov_axis: str = "x"
    width: int = 256
    height: int = 256
    sample_count: int = 16
    seed: int = 1234
    sampler: str = "independent"
    rfilter: str = "box"
    max_depth: int = 10
    rr_depth: int = 10
    integrator: dict = field(default_factory=dict)

    def add_bsdf(self, btype: int, name: str | None = None, **params) -> int:
        if btype not in SUPPORTED_BSDFS:
            raise NotImplementedError(
                f"BSDF type {btype} is not ported to sdmm_tpu_torch yet "
                "(ROADMAP A9)" if btype == BSDF_IRAWAN
                else f"unknown BSDF type {btype}")
        entry = dict(
            type=btype,
            tex=int(params.get("tex", -1)),
            albedo=np.asarray(params.get("albedo", [0.5, 0.5, 0.5]),
                              dtype=np.float64),
            specular=np.asarray(params.get("specular", [1.0, 1.0, 1.0]),
                                dtype=np.float64),
            alpha=float(params.get("alpha", 0.1)),
            eta=float(params.get("eta", 1.5046)),
            k=np.asarray(params.get("k", [0.0, 0.0, 0.0]), dtype=np.float64),
            exponent=float(params.get("exponent", 30.0)),
            alpha_v=float(params.get("alpha_v", params.get("alpha", 0.1))),
            bump=int(params.get("bump", -1)),
            bump_scale=float(params.get("bump_scale", 1.0)),
            child0=int(params.get("child0", -1)),
            child1=int(params.get("child1", -1)),
            weight=float(params.get("weight", 0.5)),
        )
        self.bsdfs.append(entry)
        idx = len(self.bsdfs) - 1
        if name is not None:
            self.bsdf_ids[name] = idx
        return idx

    def add_texture(self, image: np.ndarray) -> int:
        """Register an RGB texture; resampled to ``texture_res`` on build."""
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        self.textures.append(img[..., :3])
        return len(self.textures) - 1

    def add_proc_texture(self, kind: int, color0=(0.4, 0.4, 0.4),
                         color1=(0.2, 0.2, 0.2), uscale: float = 1.0,
                         vscale: float = 1.0, uoffset: float = 0.0,
                         voffset: float = 0.0, line_width: float = 0.01,
                         step_width: float = 0.5) -> int:
        """Register a procedural texture (``PROC_*``); returns its code
        -(idx + 2) for ``bsdf_tex``."""
        self.proc_textures.append(dict(
            kind=int(kind),
            color0=np.asarray(color0, np.float64).reshape(3),
            color1=np.asarray(color1, np.float64).reshape(3),
            uscale=float(uscale), vscale=float(vscale),
            uoffset=float(uoffset), voffset=float(voffset),
            line_width=float(line_width), step_width=float(step_width),
        ))
        return -(len(self.proc_textures) - 1) - 2

    def add_emitter(self, radiance) -> int:
        self.emitters.append(np.asarray(radiance, dtype=np.float64))
        return len(self.emitters) - 1

    def _add_light(self, kind, pos, intensity, direction, cutoff=180.0,
                   beam=180.0):
        self.point_lights.append({
            "kind": kind, "pos": np.asarray(pos, dtype=np.float64),
            "intensity": np.asarray(intensity, dtype=np.float64),
            "dir": np.asarray(direction, dtype=np.float64),
            "cutoff": float(cutoff), "beam": float(beam)})

    def add_point_light(self, position, intensity):
        self._add_light(0, position, intensity, [0.0, 0.0, 1.0])

    def add_spot_light(self, position, direction, intensity,
                       cutoff_deg=20.0, beam_deg=None):
        d = np.asarray(direction, dtype=np.float64)
        self._add_light(1, position, intensity, d / np.linalg.norm(d),
                        cutoff_deg,
                        beam_deg if beam_deg is not None
                        else cutoff_deg * 0.75)

    def add_directional_light(self, direction, irradiance):
        d = np.asarray(direction, dtype=np.float64)
        d = d / np.linalg.norm(d)
        self._add_light(2, -d, irradiance, d)  # pos: toward the light

    def add_collimated_light(self, origin, direction, power):
        """A collimated beam, delta in position and direction: NEE never
        reaches it (its direct sample always fails)."""
        d = np.asarray(direction, dtype=np.float64)
        self._add_light(3, origin, power, d / np.linalg.norm(d))

    def add_medium(self, sigma_t, albedo=None, g: float = 0.0,
                   density: np.ndarray | None = None, vol_lo=None,
                   vol_hi=None) -> int:
        """Register a medium; returns its table id (>= 1, row 0 is
        vacuum). ``density`` ([D, H, W]) makes it heterogeneous:
        sigma_t(x) = density(x)·sigma_t inside [vol_lo, vol_hi]."""
        entry = {
            "sigma_t": np.asarray(sigma_t, dtype=np.float64).reshape(3),
            "albedo": np.asarray(albedo if albedo is not None
                                 else np.ones(3), dtype=np.float64)
            .reshape(3),
            "g": float(g),
        }
        if density is not None:
            entry["density"] = np.asarray(density, dtype=np.float32)
            entry["vol_lo"] = np.asarray(
                vol_lo if vol_lo is not None else np.zeros(3), np.float64)
            entry["vol_hi"] = np.asarray(
                vol_hi if vol_hi is not None else np.ones(3), np.float64)
        self.media.append(entry)
        return len(self.media)

    def add_subsurface(self, sigma_s, sigma_a, g=0.0, eta: float = 1.3,
                       irr_samples: int = 16, sample_multiplier: float = 1.0,
                       quality: float = 0.2) -> int:
        """Register a dipole subsurface instance; returns its id."""
        self.subsurfaces.append({
            "sigma_s": np.asarray(sigma_s, dtype=np.float64).reshape(3),
            "sigma_a": np.asarray(sigma_a, dtype=np.float64).reshape(3),
            "g": np.broadcast_to(np.asarray(g, dtype=np.float64),
                                 (3,)).copy(),
            "eta": float(eta),
            "irr_samples": int(irr_samples),
            "sample_multiplier": float(sample_multiplier),
            "quality": float(quality),
        })
        return len(self.subsurfaces) - 1

    def add_shape(self, soup: TriSoup, bsdf: int, emitter: int = -1,
                  interior: int = 0, exterior: int = -1, sss: int = -1):
        """``interior``/``exterior``: medium ids (exterior -1 takes the
        scene-level medium at build); ``sss``: an add_subsurface id."""
        self.soups.append((soup, bsdf, emitter, interior, exterior, sss))

    def set_sensor(self, to_world: np.ndarray, fov_deg: float, width: int,
                   height: int, fov_axis: str = "x"):
        self.cam_to_world = np.asarray(to_world, dtype=np.float64)
        self.fov_deg = float(fov_deg)
        self.width = int(width)
        self.height = int(height)
        self.fov_axis = fov_axis

    def _pt_cdf(self):
        if not self.point_lights:
            return np.zeros(0)
        power = np.asarray([luminance(lt["intensity"])
                            for lt in self.point_lights])
        power = np.maximum(power, 1e-20)
        return np.cumsum(power / power.sum())

    def _pt_select_prob(self, area_power: float):
        """Share of NEE samples routed to the delta lights, balanced by
        total emitter power."""
        if not self.point_lights:
            return 0.0
        pt_power = sum(4.0 * np.pi * luminance(lt["intensity"])
                       for lt in self.point_lights)
        if area_power <= 0.0:
            return 1.0
        return float(pt_power / (pt_power + area_power))

    def _texture_stack(self) -> np.ndarray:
        """Every bitmap resampled (nearest) to ``texture_res``, so that a
        lookup is one [NT, R, R, 3] gather."""
        if not self.textures:
            return np.zeros((1, 1, 1, 3), np.float32)
        r = self.texture_res
        stack = np.zeros((len(self.textures), r, r, 3), np.float32)
        for ti, img in enumerate(self.textures):
            h_, w_ = img.shape[:2]
            yi = (np.arange(r) + 0.5) * h_ / r - 0.5
            xi = (np.arange(r) + 0.5) * w_ / r - 0.5
            y0 = np.clip(np.floor(yi).astype(int), 0, h_ - 1)
            x0 = np.clip(np.floor(xi).astype(int), 0, w_ - 1)
            stack[ti] = img[y0][:, x0]
        return stack

    def _env_tables(self, scene_radius: float, area_power: float):
        """The env map's NEE tables: luminance × sin θ importance over the
        equirect grid; a pixel's solid-angle pdf is lum·He·We / (2π²·total),
        the sin θ of the area element cancelling the row weight. The env
        map's share of NEE balances its power (a sphere of the scene's
        bounding radius) against the area and delta lights, within [0.1,
        0.9] when there are others."""
        if self.env_map is None or self.env_map.shape[0] <= 1:
            return np.ones(1), np.ones((1, 1)), np.zeros((1, 1)), 0.0
        he, we = self.env_map.shape[:2]
        lum = np.maximum(luminance(self.env_map), 1e-12)
        sin_t = np.sin((np.arange(he) + 0.5) * np.pi / he)
        w2d = lum * sin_t[:, None]
        total = w2d.sum()
        row_w = w2d.sum(axis=1)
        row_cdf = np.cumsum(row_w) / total
        col_cdf = np.cumsum(w2d, axis=1) / np.maximum(row_w[:, None], 1e-30)
        pdf = lum * (he * we) / (2.0 * np.pi * np.pi * total)
        scale_lum = max(luminance(self.env_radiance
                                  if self.env_radiance is not None
                                  else np.ones(3)), 1e-12)
        mean_rad = float(total / max(sin_t.sum() * we, 1e-30))
        env_power = (4.0 * np.pi ** 2 * mean_rad * scale_lum
                     * max(scene_radius, 1e-3) ** 2)
        pt_power = sum(4.0 * np.pi * luminance(lt["intensity"])
                       for lt in self.point_lights)
        select = env_power / max(env_power + area_power + pt_power, 1e-30)
        select = (float(np.clip(select, 0.1, 0.9))
                  if area_power > 0 or pt_power > 0 else 1.0)
        return row_cdf, col_cdf, pdf, select

    def _proc_rows(self, tri_bsdf, e1, e2):
        """The procedural texture rows; a wireframe with line width <= 0
        takes 10% of the mean edge length of the triangles that use it."""
        if not self.proc_textures:
            return np.zeros((0, 13))
        rows = []
        for pi, pt in enumerate(self.proc_textures):
            lw = pt["line_width"]
            if pt["kind"] == PROC_WIREFRAME and lw <= 0.0:
                code = -pi - 2
                use_b = {bi for bi, b in enumerate(self.bsdfs)
                         if b.get("tex", -1) == code}
                mask = np.isin(tri_bsdf, np.asarray(sorted(use_b)))
                if np.any(mask):
                    el = (np.linalg.norm(e1[mask], axis=-1)
                          + np.linalg.norm(e2[mask], axis=-1)
                          + np.linalg.norm((e2 - e1)[mask], axis=-1))
                    lw = 0.1 * float(el.mean()) / 3.0
                else:
                    lw = 0.01
            rows.append(np.concatenate([
                [float(pt["kind"])], pt["color0"], pt["color1"],
                [pt["uscale"], pt["vscale"], pt["uoffset"], pt["voffset"],
                 lw, pt["step_width"]]]))
        return np.stack(rows)

    def _media_rows(self):
        """The per-shape media, then the scene-level one (the ambient
        medium, 0 = vacuum when there is none)."""
        rows = list(self.media)
        if self.medium is None:
            return rows, 0
        rows.append({
            "sigma_t": np.asarray(self.medium.get("sigma_t", np.zeros(3)))
            .reshape(3),
            "albedo": np.asarray(self.medium.get("albedo", np.ones(3)))
            .reshape(3),
            "g": float(self.medium.get("g", 0.0))})
        return rows, len(rows)

    @staticmethod
    def _media_arrays(rows, ambient) -> dict:
        """The media table: row 0 vacuum, then ``rows``; each density grid
        resampled (nearest) to a 64³ cube, so that a lookup is one
        [NV, R, R, R] gather."""
        rv = 64
        vols, vol_id = [], []
        for m in rows:
            if "density" not in m:
                vol_id.append(-1)
                continue
            g = m["density"]
            idx = [np.clip(((np.arange(rv) + 0.5) * n / rv).astype(int), 0,
                           n - 1) for n in g.shape]
            vols.append(g[idx[0]][:, idx[1]][:, :, idx[2]])
            vol_id.append(len(vols) - 1)
        return dict(
            med_sigma_t=np.concatenate([np.zeros((1, 3)), np.asarray(
                [m["sigma_t"] for m in rows]).reshape(-1, 3)]),
            med_albedo=np.concatenate([np.ones((1, 3)), np.asarray(
                [m["albedo"] for m in rows]).reshape(-1, 3)]),
            med_g=np.concatenate([[0.0], [m["g"] for m in rows]]),
            ambient_med=ambient,
            med_vol=[-1] + vol_id,
            med_vol_lo=np.stack([np.zeros(3)] + [
                m.get("vol_lo", np.zeros(3)) for m in rows]),
            med_vol_inv_ext=np.stack([np.ones(3)] + [
                1.0 / np.maximum(m.get("vol_hi", np.ones(3))
                                 - m.get("vol_lo", np.zeros(3)), 1e-12)
                for m in rows]),
            med_majorant=[0.0] + [float(m["density"].max())
                                  if "density" in m else 1.0 for m in rows],
            volumes=(np.stack(vols) if vols
                     else np.zeros((1, 1, 1, 1), np.float32)),
        )

    def build(self, device="cuda") -> tuple[SceneData, RenderConfig]:
        # Imported here: render.clas reaches this module through ops.
        from ..render.clas import build_clusters

        media_rows, ambient = self._media_rows()
        all_v, all_n, all_uv, all_vc, all_b, all_e = [], [], [], [], [], []
        all_mi, all_me, all_sss = [], [], []
        any_colors = False
        for soup, bsdf_i, emitter_i, interior, exterior, sss_i in self.soups:
            v, n, uv, vc = soup.concat()
            all_v.append(v)
            all_n.append(n)
            all_uv.append(uv)
            all_vc.append(vc)
            any_colors = any_colors or soup.has_colors
            all_b.append(np.full(len(v), bsdf_i, dtype=np.int32))
            all_e.append(np.full(len(v), emitter_i, dtype=np.int32))
            all_mi.append(np.full(len(v), interior, dtype=np.int32))
            all_me.append(np.full(len(v), ambient if exterior < 0
                                  else exterior, dtype=np.int32))
            all_sss.append(np.full(len(v), sss_i, dtype=np.int32))
        verts = np.concatenate(all_v) if all_v else np.zeros((0, 3, 3))
        normals = np.concatenate(all_n) if all_n else np.zeros((0, 3, 3))
        uvs = np.concatenate(all_uv) if all_uv else np.zeros((0, 3, 2))
        vcs = np.concatenate(all_vc) if all_vc else np.zeros((0, 3, 3))
        tri_bsdf = np.concatenate(all_b) if all_b else np.zeros(0, np.int32)
        tri_emitter = (np.concatenate(all_e) if all_e
                       else np.zeros(0, np.int32))
        tri_medium, tri_medium_ext, tri_sss = (
            np.concatenate(a) if a else np.zeros(0, np.int32)
            for a in (all_mi, all_me, all_sss))

        v0 = verts[:, 0]
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        ng = np.cross(e1, e2)
        area2 = np.linalg.norm(ng, axis=-1)
        ng = ng / np.maximum(area2[:, None], 1e-20)
        # Emissive triangle distribution, weighted by power (area x
        # luminance), as the reference's power-weighted emitter CDF.
        em_idx = np.nonzero(tri_emitter >= 0)[0].astype(np.int32)
        if len(em_idx) > 0:
            areas = 0.5 * area2[em_idx]
            rad = np.array([self.emitters[tri_emitter[i]] for i in em_idx])
            power = areas * np.maximum(luminance(rad), 1e-20)
            pdf = power / power.sum()
            area_power = float(np.pi * power.sum())
            cdf = np.cumsum(pdf)
        else:
            areas = pdf = cdf = np.zeros(0)
            area_power = 0.0
        if len(verts):
            box = AABB.empty().expand(verts)
            aabb_lo, aabb_hi = box.lo, box.hi
            radius = float(np.linalg.norm(box.hi - box.lo) * 0.5)
        else:
            aabb_lo, aabb_hi = np.zeros(3), np.ones(3)
            radius = 1.0
        if not self.bsdfs:
            self.add_bsdf(BSDF_DIFFUSE)
        fov = np.deg2rad(self.fov_deg)
        clas = build_clusters(v0.astype(np.float32), e1.astype(np.float32),
                              e2.astype(np.float32))
        env_row_cdf, env_col_cdf, env_pdf, env_select = self._env_tables(
            radius, area_power)
        # Mesh-attribute tables ship only when a texture reads them: their
        # shape[0] > 0 widens surface_interaction's uv row.
        proc_tex = self._proc_rows(tri_bsdf, e1, e2)
        if len(verts) and any(pt["kind"] == PROC_WIREFRAME
                              for pt in self.proc_textures):
            l_e1 = np.maximum(np.linalg.norm(e1, axis=-1), 1e-20)
            l_e2 = np.maximum(np.linalg.norm(e2, axis=-1), 1e-20)
            l_e12 = np.maximum(np.linalg.norm(e2 - e1, axis=-1), 1e-20)
            # h_i = 2·area / |edge opposite vertex i|: the distance to that
            # edge's line is bary_i · h_i.
            tri_eh = np.stack([area2 / l_e12, area2 / l_e2, area2 / l_e1],
                              axis=-1)
        else:
            tri_eh = np.zeros((0, 3))
        lights = self.point_lights

        def rows3(key):
            return np.asarray([lt[key] for lt in lights]).reshape(-1, 3)

        arrays = dict(
            tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_ng=ng, tri_ns=normals,
            tri_uv=uvs, tri_bsdf=tri_bsdf, tri_emitter=tri_emitter,
            bsdf_type=[b["type"] for b in self.bsdfs],
            bsdf_albedo=[b["albedo"] for b in self.bsdfs],
            bsdf_specular=[b["specular"] for b in self.bsdfs],
            bsdf_alpha=[b["alpha"] for b in self.bsdfs],
            bsdf_eta=[b["eta"] for b in self.bsdfs],
            bsdf_k=[b["k"] for b in self.bsdfs],
            bsdf_exponent=[b["exponent"] for b in self.bsdfs],
            bsdf_tex=[b["tex"] for b in self.bsdfs],
            bsdf_alpha_v=[b["alpha_v"] for b in self.bsdfs],
            bsdf_bump=[b["bump"] for b in self.bsdfs],
            bsdf_bump_scale=[b["bump_scale"] for b in self.bsdfs],
            bsdf_child0=[b["child0"] for b in self.bsdfs],
            bsdf_child1=[b["child1"] for b in self.bsdfs],
            bsdf_weight=[b["weight"] for b in self.bsdfs],
            textures=self._texture_stack(),
            proc_tex=proc_tex,
            tri_vc=vcs.reshape(-1, 9) if any_colors else np.zeros((0, 9)),
            tri_eh=tri_eh,
            emitter_radiance=(np.asarray(self.emitters).reshape(-1, 3)
                              if self.emitters else np.zeros((1, 3))),
            em_tri_idx=em_idx, em_tri_cdf=cdf, em_tri_pdf=pdf,
            em_tri_area=areas,
            env_radiance=(self.env_radiance if self.env_radiance is not None
                          else np.zeros(3)),
            env_map=(self.env_map if self.env_map is not None
                     else np.zeros((1, 1, 3))),
            env_to_world=self.env_to_world,
            env_row_cdf=env_row_cdf, env_col_cdf=env_col_cdf,
            env_pdf=env_pdf, env_select_prob=env_select,
            pt_pos=rows3("pos"), pt_intensity=rows3("intensity"),
            pt_kind=[lt["kind"] for lt in lights], pt_dir=rows3("dir"),
            pt_cutoff_cos=[np.cos(np.deg2rad(lt["cutoff"])) for lt in lights],
            pt_beam_cos=[np.cos(np.deg2rad(lt["beam"])) for lt in lights],
            pt_cdf=self._pt_cdf(),
            pt_select_prob=self._pt_select_prob(area_power),
            cam_to_world=self.cam_to_world,
            cam_tan_half_fov=np.tan(0.5 * fov),
            aabb_lo=aabb_lo, aabb_hi=aabb_hi,
            clas_ids=clas["ids"], clas_woop=clas["woop"],
            clas_aabb=clas["aabb"],
            tri_medium=tri_medium, tri_medium_ext=tri_medium_ext,
            tri_sss=tri_sss,
            sss_eta=[s["eta"] for s in self.subsurfaces] or [1.0],
            sss_M=np.zeros((len(tri_sss), 3, 3)),
            **self._media_arrays(media_rows, ambient),
        )
        cfg = RenderConfig(
            width=self.width, height=self.height, max_depth=self.max_depth,
            rr_depth=self.rr_depth, fov_axis=self.fov_axis,
            bsdf_types=tuple(sorted({int(b["type"]) for b in self.bsdfs})),
            has_bump=any(b["bump"] != -1 for b in self.bsdfs),
            has_medium=self.medium is not None or len(self.media) > 0,
            has_hetero=any("density" in m for m in media_rows),
            has_sss=bool(self.subsurfaces) and bool((tri_sss >= 0).any()),
            sss=tuple(self.subsurfaces),
        )
        return scene_from_numpy(arrays, device), cfg
