"""Host-side shape → triangle-soup generation (port of
sdmm_tpu/scene/shapes.py: ``TriSoup``, ``make_rectangle``, ``make_cube``,
``make_sphere``).

Unit-shape conventions match Mitsuba 0.6 (rectangle: [-1,1]^2 in the
xy-plane, +z normal; cube: [-1,1]^3). Pure numpy.
"""

from __future__ import annotations

import numpy as np


def _transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:3, :3].T + m[:3, 3]


def _transform_normals(m: np.ndarray, ns: np.ndarray) -> np.ndarray:
    inv_t = np.linalg.inv(m[:3, :3]).T
    out = ns @ inv_t.T
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norms, 1e-20)


class TriSoup:
    """Accumulates triangles: vertices [T,3,3], shading normals [T,3,3],
    texture coordinates [T,3,2]."""

    def __init__(self):
        self.verts: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []

    def add(self, verts: np.ndarray, normals: np.ndarray | None = None,
            uvs: np.ndarray | None = None):
        verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
        if normals is None:
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            n = np.cross(e1, e2)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            normals = np.repeat(n[:, None, :], 3, axis=1)
        if uvs is None:
            uvs = np.zeros((len(verts), 3, 2))
        self.verts.append(verts)
        self.normals.append(
            np.asarray(normals, dtype=np.float64).reshape(-1, 3, 3))
        self.uvs.append(np.asarray(uvs, dtype=np.float64).reshape(-1, 3, 2))

    def concat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.verts:
            return np.zeros((0, 3, 3)), np.zeros((0, 3, 3)), np.zeros((0, 3, 2))
        return (np.concatenate(self.verts), np.concatenate(self.normals),
                np.concatenate(self.uvs))


def make_rectangle(to_world: np.ndarray, flip_normals: bool = False) -> TriSoup:
    corners = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float64
    )
    tris = np.array([[corners[0], corners[1], corners[2]],
                     [corners[0], corners[2], corners[3]]])
    uv_c = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    uvs = np.array([[uv_c[0], uv_c[1], uv_c[2]], [uv_c[0], uv_c[2], uv_c[3]]])
    n = np.array([[0.0, 0.0, 1.0]])
    world = _transform_points(to_world, tris.reshape(-1, 3)).reshape(-1, 3, 3)
    wn = _transform_normals(to_world, n)
    if flip_normals:
        wn = -wn
        world = world[:, ::-1, :]
        uvs = uvs[:, ::-1, :]
    soup = TriSoup()
    soup.add(world, np.repeat(np.repeat(wn[None], 3, axis=1), 2, axis=0)
             .reshape(-1, 3, 3), uvs)
    return soup


def make_cube(to_world: np.ndarray, flip_normals: bool = False) -> TriSoup:
    soup = TriSoup()
    # Six faces of [-1,1]^3, outward normals: (axis, sign).
    faces = [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]
    for axis, sign in faces:
        u_axis, v_axis = [a for a in range(3) if a != axis]
        corners = np.zeros((4, 3))
        corners[:, axis] = sign
        uv = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float64)
        if sign < 0:
            uv = uv[:, ::-1]
        corners[:, u_axis] = uv[:, 0]
        corners[:, v_axis] = uv[:, 1]
        tris = np.array([[corners[0], corners[1], corners[2]],
                         [corners[0], corners[2], corners[3]]])
        world = _transform_points(
            to_world, tris.reshape(-1, 3)).reshape(-1, 3, 3)
        if flip_normals:
            world = world[:, ::-1, :]
        soup.add(world)
    return soup


def make_sphere(center: np.ndarray, radius: float,
                to_world: np.ndarray | None = None, n_theta: int = 32,
                n_phi: int = 64, flip_normals: bool = False) -> TriSoup:
    """Tessellated UV sphere with smooth shading normals; the degenerate
    triangles at the poles are dropped."""
    theta = np.linspace(0.0, np.pi, n_theta + 1)
    phi = np.linspace(0.0, 2 * np.pi, n_phi + 1)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], axis=-1)
    verts, normals = [], []
    for i in range(n_theta):
        for j in range(n_phi):
            quad = [pts[i, j], pts[i + 1, j], pts[i + 1, j + 1],
                    pts[i, j + 1]]
            for tri in ([quad[0], quad[1], quad[2]],
                        [quad[0], quad[2], quad[3]]):
                tri = np.asarray(tri)
                if np.linalg.norm(np.cross(tri[1] - tri[0],
                                           tri[2] - tri[0])) < 1e-12:
                    continue
                verts.append(tri)
                normals.append(tri.copy())
    verts = np.asarray(verts) * radius + np.asarray(center)
    normals = np.asarray(normals)
    if to_world is not None:
        verts = _transform_points(
            to_world, verts.reshape(-1, 3)).reshape(-1, 3, 3)
        normals = _transform_normals(
            to_world, normals.reshape(-1, 3)).reshape(-1, 3, 3)
    if flip_normals:
        normals = -normals
        verts = verts[:, ::-1, :]
    soup = TriSoup()
    soup.add(verts, normals)
    return soup
