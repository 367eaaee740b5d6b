"""Scene container: host-side builder → device SoA tensors (port of
sdmm_tpu/scene/scene.py, cut to what the guided training render reads).

``SceneData`` keeps the triangle arrays, the BSDF table of the four types
the guided path supports in-kernel (diffuse, conductor, dielectric,
roughconductor), the emitter radiance table with the power-weighted
emissive-triangle distribution, a constant environment, the camera, the
scene AABB (the guiding normalization domain) and the triangle clusters of
the cluster-cull intersector (``render/clas.py``, ``ops/clas_cull.py``):
the reference's arrays, plus two that only the port's kernel reads
(``PORT_FIELDS``), derived from them.
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

SUPPORTED_BSDFS = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                   BSDF_ROUGHCONDUCTOR)


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
    emitter_radiance: torch.Tensor  # [E, 3]
    em_tri_idx: torch.Tensor  # [M] int32 triangle ids of emissive tris
    em_tri_cdf: torch.Tensor  # [M] CDF over emissive tris (by power)
    em_tri_pdf: torch.Tensor  # [M] discrete probability of each tri
    em_tri_area: torch.Tensor  # [M]
    env_radiance: torch.Tensor  # [3] constant environment
    cam_to_world: torch.Tensor  # [4, 4]
    cam_tan_half_fov: torch.Tensor  # []
    aabb_lo: torch.Tensor  # [3]
    aabb_hi: torch.Tensor  # [3]
    # Morton-ordered triangle clusters (render/clas.build_clusters).
    clas_ids: torch.Tensor  # [C, Tc] int32 original tri ids (-1 pad)
    clas_woop: torch.Tensor  # [C, 12, Tc] Woop rows (ops/clas_cull)
    clas_aabb: torch.Tensor  # [8, Cp] padded AABB table (ops/clas_cull)
    # The port's own: derived from the clusters above by scene_from_numpy.
    clas_tree: torch.Tensor  # [2P, 8] tree over the boxes (build_tree)
    clas_woop_slot: torch.Tensor  # [C, Tc, 12] Woop rows by slot (slot_rows)


# Fields the reference's SceneData does not have.
PORT_FIELDS = ("clas_tree", "clas_woop_slot")


_INT_FIELDS = ("tri_bsdf", "tri_emitter", "bsdf_type", "em_tri_idx",
               "clas_ids")


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


@dataclass
class SceneBuilder:
    soups: list = field(default_factory=list)
    bsdfs: list[dict] = field(default_factory=list)
    bsdf_ids: dict = field(default_factory=dict)
    emitters: list[np.ndarray] = field(default_factory=list)
    env_radiance: np.ndarray | None = None
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
                f"BSDF type {btype} is not ported (supported: "
                f"{SUPPORTED_BSDFS})")
        if int(params.get("tex", -1)) != -1:
            raise NotImplementedError("textured BSDFs are not ported")
        entry = dict(
            type=btype,
            albedo=np.asarray(params.get("albedo", [0.5, 0.5, 0.5]),
                              dtype=np.float64),
            specular=np.asarray(params.get("specular", [1.0, 1.0, 1.0]),
                                dtype=np.float64),
            alpha=float(params.get("alpha", 0.1)),
            eta=float(params.get("eta", 1.5046)),
            k=np.asarray(params.get("k", [0.0, 0.0, 0.0]), dtype=np.float64),
        )
        self.bsdfs.append(entry)
        idx = len(self.bsdfs) - 1
        if name is not None:
            self.bsdf_ids[name] = idx
        return idx

    def add_emitter(self, radiance) -> int:
        self.emitters.append(np.asarray(radiance, dtype=np.float64))
        return len(self.emitters) - 1

    def add_shape(self, soup: TriSoup, bsdf: int, emitter: int = -1):
        self.soups.append((soup, bsdf, emitter))

    def set_sensor(self, to_world: np.ndarray, fov_deg: float, width: int,
                   height: int, fov_axis: str = "x"):
        self.cam_to_world = np.asarray(to_world, dtype=np.float64)
        self.fov_deg = float(fov_deg)
        self.width = int(width)
        self.height = int(height)
        self.fov_axis = fov_axis

    def build(self, device="cuda") -> tuple[SceneData, RenderConfig]:
        # Imported here: render.clas reaches this module through ops.
        from ..render.clas import build_clusters

        all_v, all_n, all_uv, all_b, all_e = [], [], [], [], []
        for soup, bsdf_i, emitter_i in self.soups:
            v, n, uv = soup.concat()
            all_v.append(v)
            all_n.append(n)
            all_uv.append(uv)
            all_b.append(np.full(len(v), bsdf_i, dtype=np.int32))
            all_e.append(np.full(len(v), emitter_i, dtype=np.int32))
        verts = np.concatenate(all_v) if all_v else np.zeros((0, 3, 3))
        normals = np.concatenate(all_n) if all_n else np.zeros((0, 3, 3))
        uvs = np.concatenate(all_uv) if all_uv else np.zeros((0, 3, 2))
        tri_bsdf = np.concatenate(all_b) if all_b else np.zeros(0, np.int32)
        tri_emitter = (np.concatenate(all_e) if all_e
                       else np.zeros(0, np.int32))

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
            cdf = np.cumsum(pdf)
        else:
            areas = pdf = cdf = np.zeros(0)
        if len(verts):
            box = AABB.empty().expand(verts)
            aabb_lo, aabb_hi = box.lo, box.hi
        else:
            aabb_lo, aabb_hi = np.zeros(3), np.ones(3)
        if not self.bsdfs:
            self.add_bsdf(BSDF_DIFFUSE)
        fov = np.deg2rad(self.fov_deg)
        clas = build_clusters(v0.astype(np.float32), e1.astype(np.float32),
                              e2.astype(np.float32))
        arrays = dict(
            tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_ng=ng, tri_ns=normals,
            tri_uv=uvs, tri_bsdf=tri_bsdf, tri_emitter=tri_emitter,
            bsdf_type=[b["type"] for b in self.bsdfs],
            bsdf_albedo=[b["albedo"] for b in self.bsdfs],
            bsdf_specular=[b["specular"] for b in self.bsdfs],
            bsdf_alpha=[b["alpha"] for b in self.bsdfs],
            bsdf_eta=[b["eta"] for b in self.bsdfs],
            bsdf_k=[b["k"] for b in self.bsdfs],
            emitter_radiance=(np.asarray(self.emitters).reshape(-1, 3)
                              if self.emitters else np.zeros((1, 3))),
            em_tri_idx=em_idx, em_tri_cdf=cdf, em_tri_pdf=pdf,
            em_tri_area=areas,
            env_radiance=(self.env_radiance if self.env_radiance is not None
                          else np.zeros(3)),
            cam_to_world=self.cam_to_world,
            cam_tan_half_fov=np.tan(0.5 * fov),
            aabb_lo=aabb_lo, aabb_hi=aabb_hi,
            clas_ids=clas["ids"], clas_woop=clas["woop"],
            clas_aabb=clas["aabb"],
        )
        cfg = RenderConfig(
            width=self.width, height=self.height, max_depth=self.max_depth,
            rr_depth=self.rr_depth, fov_axis=self.fov_axis,
            bsdf_types=tuple(sorted({int(b["type"]) for b in self.bsdfs})),
        )
        return scene_from_numpy(arrays, device), cfg
