"""Host-side shape → triangle-soup generation (port of
sdmm_tpu/scene/shapes.py: ``TriSoup``, the rectangle, cube, sphere, disk
and cylinder, hair fibers, heightfields, indexed meshes, the OBJ loader and
the curvature bake).

Unit-shape conventions match Mitsuba 0.6 (rectangle: [-1,1]^2 in the
xy-plane, +z normal; cube: [-1,1]^3; disk: the unit disk at z = 0). Pure
numpy. A soup may carry per-corner colours, which feed the mesh-attribute
textures (vertexcolors, and curvature baked to colours).
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
    texture coordinates [T,3,2], per-corner colours [T,3,3] (zero unless
    ``has_colors``)."""

    def __init__(self):
        self.verts: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.colors: list[np.ndarray] = []
        self.has_colors = False

    def add(self, verts: np.ndarray, normals: np.ndarray | None = None,
            uvs: np.ndarray | None = None,
            colors: np.ndarray | None = None):
        verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
        if normals is None:
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            n = np.cross(e1, e2)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            normals = np.repeat(n[:, None, :], 3, axis=1)
        if uvs is None:
            uvs = np.zeros((len(verts), 3, 2))
        if colors is None:
            colors = np.zeros((len(verts), 3, 3))
        else:
            self.has_colors = True
        self.verts.append(verts)
        self.normals.append(
            np.asarray(normals, dtype=np.float64).reshape(-1, 3, 3))
        self.uvs.append(np.asarray(uvs, dtype=np.float64).reshape(-1, 3, 2))
        self.colors.append(
            np.asarray(colors, dtype=np.float64).reshape(-1, 3, 3))

    def concat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
        """(vertices, normals, uvs, colours) of every triangle."""
        if not self.verts:
            return (np.zeros((0, 3, 3)), np.zeros((0, 3, 3)),
                    np.zeros((0, 3, 2)), np.zeros((0, 3, 3)))
        return (np.concatenate(self.verts), np.concatenate(self.normals),
                np.concatenate(self.uvs), np.concatenate(self.colors))

    def transformed(self, to_world: np.ndarray) -> "TriSoup":
        """A copy with ``to_world`` applied: an instance is flattened into
        transformed triangle copies at build time."""
        v, n, uv, vc = self.concat()
        out = TriSoup()
        if len(v):
            out.add(
                _transform_points(to_world, v.reshape(-1, 3))
                .reshape(-1, 3, 3),
                _transform_normals(to_world, n.reshape(-1, 3))
                .reshape(-1, 3, 3),
                uv, vc if self.has_colors else None)
        return out


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


def make_disk(to_world: np.ndarray, n_phi: int = 64,
              flip_normals: bool = False) -> TriSoup:
    """Unit disk in the z=0 plane, a triangle fan with smooth +z
    normals."""
    phi = np.linspace(0.0, 2 * np.pi, n_phi + 1)
    rim = np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], axis=-1)
    verts, uvs = [], []
    center = np.zeros(3)
    for j in range(n_phi):
        tri = np.asarray([center, rim[j], rim[j + 1]])
        verts.append(tri)
        uvs.append(0.5 * (tri[:, :2] + 1.0))
    verts = np.asarray(verts)
    uvs = np.asarray(uvs)
    normals = np.broadcast_to(np.array([0.0, 0.0, 1.0]), verts.shape).copy()
    verts_w = _transform_points(
        to_world, verts.reshape(-1, 3)).reshape(-1, 3, 3)
    normals_w = _transform_normals(
        to_world, normals.reshape(-1, 3)).reshape(-1, 3, 3)
    if flip_normals:
        normals_w = -normals_w
        verts_w = verts_w[:, ::-1, :]
        uvs = uvs[:, ::-1, :]
    soup = TriSoup()
    soup.add(verts_w, normals_w, uvs)
    return soup


def make_cylinder(p0: np.ndarray, p1: np.ndarray, radius: float,
                  to_world: np.ndarray | None = None, n_phi: int = 32,
                  flip_normals: bool = False) -> TriSoup:
    """Open cylinder from p0 to p1 (no end caps, as Mitsuba's), with
    smooth radial normals."""
    p0 = np.asarray(p0, dtype=np.float64)[None]
    p1 = np.asarray(p1, dtype=np.float64)[None]
    axis = p1 - p0
    verts, normals, uvs = _cylinders(p0, p1, axis,
                                     np.asarray([np.linalg.norm(axis[0])]),
                                     radius, n_phi)
    if to_world is not None:
        verts = _transform_points(
            to_world, verts.reshape(-1, 3)).reshape(-1, 3, 3)
        normals = _transform_normals(
            to_world, normals.reshape(-1, 3)).reshape(-1, 3, 3)
    if flip_normals:
        normals = -normals
        verts = verts[:, ::-1, :]
        uvs = uvs[:, ::-1, :]
    soup = TriSoup()
    soup.add(verts, normals, uvs)
    return soup

def _read_hair_fibers(filename: str) -> list[np.ndarray]:
    """The fibers of a hair file, each [n >= 2, 3] float64: the
    "BINARY_HAIR" float32 stream (an inf x-coordinate starts a new fiber)
    or the whitespace text format (a line of fewer than three numbers
    starts one)."""
    fibers: list[np.ndarray] = []
    with open(filename, "rb") as f:
        header = f.read(11)
        if header == b"BINARY_HAIR":
            import struct

            (n_verts,) = struct.unpack("<I", f.read(4))
            data = np.frombuffer(f.read(4 * 3 * n_verts),
                                 dtype="<f4").reshape(-1, 3)
            cur: list[np.ndarray] = []
            for v in data:
                if np.isinf(v[0]):
                    if len(cur) >= 2:
                        fibers.append(np.asarray(cur))
                    cur = []
                else:
                    cur.append(v.astype(np.float64))
            if len(cur) >= 2:
                fibers.append(np.asarray(cur))
            return fibers
        f.seek(0)
        cur = []
        for line in f.read().decode("utf-8", "ignore").splitlines():
            parts = line.split()
            if len(parts) < 3:
                if len(cur) >= 2:
                    fibers.append(np.asarray(cur))
                cur = []
                continue
            cur.append(np.array([float(x) for x in parts[:3]]))
        if len(cur) >= 2:
            fibers.append(np.asarray(cur))
    return fibers


def load_hair(filename: str, radius: float = 0.025,
              to_world: np.ndarray | None = None, n_sides: int = 4,
              reduction: float = 0.0,
              angle_threshold_deg: float = 1.0) -> TriSoup:
    """Hair fibers → open cylinders of ``n_sides`` sides per segment.
    Interior vertices where the fiber turns by less than
    ``angle_threshold_deg`` are dropped; ``reduction`` drops that fraction
    of the fibers at random (``np.random.default_rng(0)``, as the
    reference) and widens the radius to compensate."""
    fibers = _read_hair_fibers(filename)
    if reduction > 0:
        rng = np.random.default_rng(0)
        keep = rng.random(len(fibers)) >= reduction
        fibers = [fb for fb, k in zip(fibers, keep) if k]
        radius *= 1.0 / np.sqrt(max(1.0 - reduction, 1e-6))
    cos_thresh = np.cos(np.deg2rad(angle_threshold_deg))
    seg_a, seg_b = [], []
    for fiber in fibers:
        pts = [fiber[0]]
        for i in range(1, len(fiber) - 1):
            d0 = fiber[i] - pts[-1]
            d1 = fiber[i + 1] - fiber[i]
            n0, n1 = np.linalg.norm(d0), np.linalg.norm(d1)
            if n0 < 1e-12:
                continue
            if n1 > 1e-12 and np.dot(d0, d1) / (n0 * n1) > cos_thresh:
                continue
            pts.append(fiber[i])
        pts.append(fiber[-1])
        seg_a += pts[:-1]
        seg_b += pts[1:]
    soup = TriSoup()
    if seg_a:
        p0, p1 = np.asarray(seg_a), np.asarray(seg_b)
        axis = p1 - p0
        length = np.asarray([np.linalg.norm(d) for d in axis])
        keep = length >= 1e-12
        if keep.any():
            # Zero colours, as the reference's soup.add(*concat()) gives.
            v, n, uv = _cylinders(p0[keep], p1[keep], axis[keep],
                                  length[keep], radius, n_sides)
            soup.add(v, n, uv, np.zeros_like(v))
    if to_world is not None:
        soup = soup.transformed(to_world)
    return soup


def _cylinders(p0, p1, axis, length, radius, n_phi):
    """Open cylinders of n_phi sides around the segments p0[i] -> p1[i]
    ([S, 3]; axis = p1 - p0 and length its norm): (verts, normals, uvs) of
    their triangles in order, 2·n_phi a segment, with smooth radial
    normals. Every vector norm is np.linalg.norm's of one vector, so that a
    batch gives each segment's cylinder bit for bit."""
    s = len(p0)
    z = axis / np.maximum(length, 1e-12)[:, None]
    a = np.where((np.abs(z[:, 0]) < 0.9)[:, None], [1.0, 0.0, 0.0],
                 [0.0, 1.0, 0.0])
    x = np.cross(z, a)
    x /= np.asarray([np.linalg.norm(v) for v in x])[:, None]
    y = np.cross(z, x)
    phi = np.linspace(0.0, 2 * np.pi, n_phi + 1)
    ring_n = (np.cos(phi)[None, :, None] * x[:, None, :]
              + np.sin(phi)[None, :, None] * y[:, None, :])  # [S, n+1, 3]
    lo = p0[:, None, :] + radius * ring_n
    hi = p1[:, None, :] + radius * ring_n
    j, j1 = np.arange(n_phi), np.arange(1, n_phi + 1)
    # Quad j is (lo j, hi j, hi j+1, lo j+1), split as (0, 1, 2), (0, 2, 3).
    verts = np.stack([np.stack([lo[:, j], hi[:, j], hi[:, j1]], 2),
                      np.stack([lo[:, j], hi[:, j1], lo[:, j1]], 2)], 2)
    normals = np.stack([
        np.stack([ring_n[:, j], ring_n[:, j], ring_n[:, j1]], 2),
        np.stack([ring_n[:, j], ring_n[:, j1], ring_n[:, j1]], 2)], 2)
    u0, u1 = phi[j] / (2 * np.pi), phi[j1] / (2 * np.pi)
    zero, one = np.zeros(n_phi), np.ones(n_phi)
    q = [np.stack([u0, zero], -1), np.stack([u0, one], -1),
         np.stack([u1, one], -1), np.stack([u1, zero], -1)]
    uvs = np.stack([np.stack([q[0], q[1], q[2]], 1),
                    np.stack([q[0], q[2], q[3]], 1)], 1)  # [n, 2, 3, 2]
    uvs = np.broadcast_to(uvs[None], (s,) + uvs.shape)
    return (verts.reshape(-1, 3, 3), normals.reshape(-1, 3, 3),
            uvs.reshape(-1, 3, 2))

def mesh_to_soup(mesh: dict, to_world: np.ndarray | None = None,
                 flip_normals: bool = False) -> TriSoup:
    """Indexed mesh dict (positions, normals, uv, colors, faces) → triangle
    soup; zero-area triangles are dropped."""
    v = mesh["positions"]
    faces = mesh["faces"]
    vn = None if mesh.get("face_normals") else mesh.get("normals")
    vt = mesh.get("uv")
    vc = mesh.get("colors")
    tri_v = v[faces]
    tri_n = vn[faces] if vn is not None else None
    tri_uv = vt[faces] if vt is not None else None
    tri_c = vc[faces] if vc is not None else None
    if to_world is not None:
        tri_v = _transform_points(
            to_world, tri_v.reshape(-1, 3)).reshape(-1, 3, 3)
        if tri_n is not None:
            tri_n = _transform_normals(
                to_world, tri_n.reshape(-1, 3)).reshape(-1, 3, 3)
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    keep = np.linalg.norm(np.cross(e1, e2), axis=-1) > 1e-16
    tri_v = tri_v[keep]
    tri_n = tri_n[keep] if tri_n is not None else None
    tri_uv = tri_uv[keep] if tri_uv is not None else None
    tri_c = tri_c[keep] if tri_c is not None else None
    if flip_normals:
        tri_v = tri_v[:, ::-1, :]
        if tri_n is not None:
            tri_n = -tri_n[:, ::-1, :]
        if tri_uv is not None:
            tri_uv = tri_uv[:, ::-1, :]
        if tri_c is not None:
            tri_c = tri_c[:, ::-1, :]
    soup = TriSoup()
    if len(tri_v):
        soup.add(tri_v, tri_n, tri_uv, tri_c)
    return soup


def vertex_curvature(mesh: dict, kind: str = "gaussian") -> np.ndarray:
    """Discrete per-vertex curvature of an indexed mesh: ``gaussian`` the
    angle defect (2π − Σ incident angles) / (A/3), ``mean`` the cotangent
    Laplacian |Δp| / (2·A/3), signed by the mean normal."""
    v = np.asarray(mesh["positions"], dtype=np.float64)
    f = np.asarray(mesh["faces"], dtype=np.int64)
    nv = len(v)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    area = np.maximum(0.5 * np.linalg.norm(fn, axis=-1), 1e-20)
    varea = np.zeros(nv)
    vnorm = np.zeros((nv, 3))
    for i in range(3):
        np.add.at(varea, f[:, i], area / 3.0)
        np.add.at(vnorm, f[:, i], fn)
    vnorm /= np.maximum(np.linalg.norm(vnorm, axis=-1, keepdims=True), 1e-20)

    if kind == "gaussian":
        defect = np.full(nv, 2.0 * np.pi)
        for i in range(3):
            a = v[f[:, i]]
            e1 = v[f[:, (i + 1) % 3]] - a
            e2 = v[f[:, (i + 2) % 3]] - a
            cosang = np.sum(e1 * e2, -1) / np.maximum(
                np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1),
                1e-20)
            np.add.at(defect, f[:, i], -np.arccos(np.clip(cosang, -1, 1)))
        return defect / np.maximum(varea, 1e-20)

    # Mean curvature normal: Δp_i = Σ_j (cot α_ij + cot β_ij)(p_j − p_i)/2.
    lap = np.zeros((nv, 3))
    for i in range(3):
        ia, ib, ic = f[:, i], f[:, (i + 1) % 3], f[:, (i + 2) % 3]
        e1 = v[ia] - v[ic]
        e2 = v[ib] - v[ic]
        cot = np.sum(e1 * e2, -1) / np.maximum(
            np.linalg.norm(np.cross(e1, e2), axis=-1), 1e-20)
        w = 0.5 * cot
        np.add.at(lap, ia, w[:, None] * (v[ib] - v[ia]))
        np.add.at(lap, ib, w[:, None] * (v[ia] - v[ib]))
    h = np.linalg.norm(lap, axis=-1) / np.maximum(2.0 * varea, 1e-20)
    sign = np.where(np.sum(lap * vnorm, -1) < 0.0, 1.0, -1.0)
    return sign * h


def bake_curvature(soup: TriSoup, kind: str = "gaussian",
                   scale: float = 1.0) -> TriSoup:
    """The curvature texture's colour ramp (positive → red, negative →
    blue) baked into per-corner colours; coincident corners are welded to
    recover the mesh's connectivity."""
    v, n, uv, _ = soup.concat()
    if not len(v):
        return soup
    flat = v.reshape(-1, 3)
    ext = float(np.max(np.ptp(flat, axis=0))) or 1.0
    key = np.round(flat / (1e-6 * ext)).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    mesh = {"positions": flat[first], "faces": inv.reshape(-1, 3)}
    vals = vertex_curvature(mesh, kind)
    r = np.clip(vals * scale, 0.0, 1.0)
    b = np.clip(-vals * scale, 0.0, 1.0)
    cols = np.stack([r, np.zeros_like(r), b], axis=-1)
    out = TriSoup()
    out.add(v, n, uv, cols[inv.reshape(-1, 3)])
    return out


def check_lfs_stub(path: str) -> None:
    """Raise a clear error for a git-lfs pointer stub in place of the
    asset."""
    try:
        with open(path, "rb") as f:
            head = f.read(40)
    except OSError:
        return
    if head.startswith(b"version https://git-lfs"):
        raise ValueError(f"{path}: git-lfs pointer stub, not the actual "
                         "asset")


def load_obj(path: str, to_world: np.ndarray | None = None,
             flip_normals: bool = False, face_normals: bool = False,
             native: bool = True) -> TriSoup:
    """OBJ loader (v/vn/vt/f, polygons fan-triangulated). The native
    parser (``native.obj_load``) runs unless ``native`` is False or
    SDMM_TPU_NO_NATIVE is set (``native.disabled``); this module's Python
    parser is its plain twin."""
    from ..native import disabled

    check_lfs_stub(path)
    if native and not disabled():
        from ..native import obj_load

        v_t, n_t, uv_t = obj_load(path)
        if face_normals and len(v_t):
            e1 = v_t[:, 1] - v_t[:, 0]
            e2 = v_t[:, 2] - v_t[:, 0]
            fn = np.cross(e1, e2)
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                             1e-20)
            n_t = np.repeat(fn[:, None, :], 3, axis=1)
        if to_world is not None and len(v_t):
            v_t = _transform_points(
                to_world, v_t.reshape(-1, 3)).reshape(-1, 3, 3)
            n_t = _transform_normals(
                to_world, n_t.reshape(-1, 3)).reshape(-1, 3, 3)
        if flip_normals and len(v_t):
            v_t = v_t[:, ::-1]
            n_t = -n_t[:, ::-1]
            uv_t = uv_t[:, ::-1]
        soup = TriSoup()
        if len(v_t):
            soup.add(v_t, n_t, uv_t)
        return soup

    vs, vns, vts, faces = [], [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                vns.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vts.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    idx.append((vi, ti, ni))
                faces.append(idx)
    v = np.asarray(vs, dtype=np.float64)
    vn = np.asarray(vns, dtype=np.float64) if vns else None
    vt = np.asarray(vts, dtype=np.float64) if vts else None

    def res(i, n):
        return i - 1 if i > 0 else n + i

    soup = TriSoup()
    for face in faces:
        for k in range(1, len(face) - 1):
            ids = [face[0], face[k], face[k + 1]]
            pv = np.array([v[res(i, len(v))] for i, _, _ in ids])
            pn = pt = None
            if vn is not None and not face_normals and \
                    all(ni != 0 for _, _, ni in ids):
                pn = np.array([vn[res(ni, len(vn))] for _, _, ni in ids])
            if vt is not None and all(ti != 0 for _, ti, _ in ids):
                pt = np.array([vt[res(ti, len(vt))] for _, ti, _ in ids])
            if to_world is not None:
                pv = _transform_points(to_world, pv)
                if pn is not None:
                    pn = _transform_normals(to_world, pn)
            if flip_normals:
                pv = pv[::-1]
                if pn is not None:
                    pn = -pn[::-1]
                if pt is not None:
                    pt = pt[::-1]
            soup.add(pv[None], None if pn is None else pn[None],
                     None if pt is None else pt[None])
    return soup


def _round_pow2_plus_1(n: int) -> int:
    """The smallest 2^k + 1 >= n: a heightfield's W - 1 and H - 1 are
    rounded up to powers of two."""
    n = max(n, 2)
    k = n - 1
    if k & (k - 1) == 0:
        return n
    return (1 << (k - 1).bit_length()) + 1


def load_height_data(path: str, scale: float = 1.0) -> np.ndarray:
    """An image file → its luminance (ITU-R 709 weights) as a height grid
    [H, W] float64, times ``scale``. EXR is read by ``utils/exr.py`` and
    PNG by ``utils/png.py``; any other format needs PIL, and without it
    raises naming the file. Integer images above 1.5 are divided by 255."""
    from ..utils.png import PNG_SIGNATURE, read_png

    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "exr":
        from ..utils.exr import read_exr

        img = np.asarray(read_exr(path), dtype=np.float64)
    else:
        with open(path, "rb") as f:
            is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
        if is_png:
            img = read_png(path).astype(np.float64)
        else:
            try:
                from PIL import Image
            except ImportError as exc:
                raise RuntimeError(
                    f"{path}: only EXR and PNG height maps are decoded "
                    "without PIL, which is not installed") from exc
            img = np.asarray(Image.open(path), dtype=np.float64)
        if img.max(initial=0.0) > 1.5:
            img = img / 255.0
    if img.ndim == 3:
        if img.shape[-1] >= 3:
            img = (0.212671 * img[..., 0] + 0.715160 * img[..., 1]
                   + 0.072169 * img[..., 2])
        else:
            img = img[..., 0]
    return img * scale


def _resample_bilinear(data: np.ndarray, w: int, h: int) -> np.ndarray:
    """Clamped bilinear resample of [h0, w0] to [h, w]."""
    h0, w0 = data.shape
    if (h0, w0) == (h, w):
        return data
    ys = np.linspace(0, h0 - 1, h)
    xs = np.linspace(0, w0 - 1, w)
    y0 = np.clip(np.floor(ys).astype(int), 0, h0 - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w0 - 1)
    y1 = np.minimum(y0 + 1, h0 - 1)
    x1 = np.minimum(x0 + 1, w0 - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    d00 = data[np.ix_(y0, x0)]
    d01 = data[np.ix_(y0, x1)]
    d10 = data[np.ix_(y1, x0)]
    d11 = data[np.ix_(y1, x1)]
    return (d00 * (1 - fy) * (1 - fx) + d01 * (1 - fy) * fx
            + d10 * fy * (1 - fx) + d11 * fy * fx)


def make_heightfield(data: np.ndarray, to_world: np.ndarray | None = None,
                     shading_normals: bool = True,
                     flip_normals: bool = False) -> TriSoup:
    """A height grid → two triangles a cell. The grid is resampled so that
    W - 1 and H - 1 are powers of two and placed on [-1, 1]^2 in xy with
    z = height; uv = grid / (W - 1, H - 1). Shading normals are the
    normalised (-dz/dx, -dz/dy, 1) of ``np.gradient`` (central differences
    inside, one-sided at the border), else the faces' own."""
    data = np.asarray(data, dtype=np.float64)
    h0, w0 = data.shape
    w = _round_pow2_plus_1(w0)
    h = _round_pow2_plus_1(h0)
    data = _resample_bilinear(data, w, h)

    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    obj = np.stack(
        [xs * (2.0 / (w - 1)) - 1.0, ys * (2.0 / (h - 1)) - 1.0, data],
        axis=-1).reshape(-1, 3)
    uv = np.stack([xs / (w - 1), ys / (h - 1)], axis=-1).reshape(-1, 2)
    dz_dy, dz_dx = np.gradient(data, 2.0 / (h - 1), 2.0 / (w - 1))
    vn = np.stack([-dz_dx, -dz_dy, np.ones_like(data)],
                  axis=-1).reshape(-1, 3)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)

    i = (ys[:-1, :-1] * w + xs[:-1, :-1]).reshape(-1)
    v00, v10, v01, v11 = i, i + 1, i + w, i + w + 1
    faces = np.concatenate([np.stack([v00, v10, v11], axis=-1),
                            np.stack([v00, v11, v01], axis=-1)], axis=0)
    mesh = {"positions": obj, "faces": faces, "uv": uv}
    if shading_normals:
        mesh["normals"] = vn
    else:
        mesh["face_normals"] = True
    return mesh_to_soup(mesh, to_world, flip_normals)
