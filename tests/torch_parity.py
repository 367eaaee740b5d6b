"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py):
the same scenes and mixture states built from numpy for both packages."""

import numpy as np
import torch

from sdmm_tpu_torch.guiding import mixture as tmix
from sdmm_tpu_torch.ops import guided_sample as tgs


def compose(translate, scale, rx=0.0, ry=0.0):
    m = np.eye(4)
    m[:3, :3] = np.diag(scale)
    rxm = np.eye(4)
    a = np.deg2rad(rx)
    rxm[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    rym = np.eye(4)
    a = np.deg2rad(ry)
    rym[0, 0] = rym[2, 2] = np.cos(a)
    rym[0, 2] = np.sin(a)
    rym[2, 0] = -np.sin(a)
    out = np.eye(4)
    out[:3, 3] = translate
    return out @ rym @ rxm @ m


def make_box(scene_mod, shapes_mod, width=16, height=16, extra_bsdfs=False):
    """The closed Cornell-like box of tests/test_render.py built with either
    package's SceneBuilder. ``extra_bsdfs`` adds a conductor, a dielectric
    and a rough-conductor cube (the other in-kernel BSDF types)."""
    b = scene_mod.SceneBuilder()
    white = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.725, 0.71, 0.68])
    red = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.63, 0.065, 0.05])
    green = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.14, 0.45, 0.091])
    black = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.0, 0.0, 0.0])
    em = b.add_emitter([20.0, 20.0, 20.0])

    def rect(to_world, bsdf, emitter=-1):
        b.add_shape(shapes_mod.make_rectangle(np.asarray(to_world)), bsdf,
                    emitter)

    rect(compose([0, 0, 0], [1, 1, 1], rx=-90), white)
    rect(compose([0, 2, 0], [1, 1, 1], rx=90), white)
    rect(compose([0, 1, -1], [1, 1, 1]), white)
    rect(compose([-1, 1, 0], [1, 1, 1], ry=90), red)
    rect(compose([1, 1, 0], [1, 1, 1], ry=-90), green)
    rect(compose([0, 1.98, 0], [0.3, 0.3, 1], rx=90), black, em)
    if extra_bsdfs:
        cond = b.add_bsdf(scene_mod.BSDF_CONDUCTOR, specular=[0.9, 0.9, 0.9],
                          eta=0.2, k=[3.9, 2.4, 2.1])
        diel = b.add_bsdf(scene_mod.BSDF_DIELECTRIC, eta=1.5)
        rough = b.add_bsdf(scene_mod.BSDF_ROUGHCONDUCTOR, alpha=0.2,
                           eta=0.2, k=[3.9, 2.4, 2.1])
        b.add_shape(shapes_mod.make_cube(
            compose([-0.45, 0.3, -0.3], [0.25, 0.3, 0.25], ry=20)), cond)
        b.add_shape(shapes_mod.make_cube(
            compose([0.45, 0.25, 0.2], [0.2, 0.25, 0.2], ry=-15)), diel)
        b.add_shape(shapes_mod.make_cube(
            compose([0.0, 1.3, -0.5], [0.15, 0.15, 0.15], rx=30)), rough)
    cam = np.eye(4)
    cam[:3, 3] = [0.0, 1.0, 4.0]
    cam[0, 0] = -1.0
    cam[2, 2] = -1.0
    b.set_sensor(cam, fov_deg=40.0, width=width, height=height)
    b.max_depth = 5
    b.rr_depth = 5
    return b


def make_rough_box(scene_mod, shapes_mod, width=12, height=12):
    """tests/test_diff.py's rough_scene: the box with a rough-conductor slab
    (GGX alpha a scene parameter), max depth 3, with either package's
    SceneBuilder."""
    b = make_box(scene_mod, shapes_mod, width, height)
    m = b.add_bsdf(scene_mod.BSDF_ROUGHCONDUCTOR, specular=[0.9, 0.9, 0.9],
                   eta=0.2, k=[3.0, 3.0, 3.0], alpha=0.3)
    t = np.eye(4)
    t[:3, 3] = [0.0, 0.45, -0.5]
    t[0, 0] = t[1, 1] = 0.5
    b.add_shape(shapes_mod.make_rectangle(t), m)
    b.max_depth = 3
    b.rr_depth = 3
    return b


def make_glossy_box(scene_mod, shapes_mod, width=24, height=24):
    """The 18-triangle box of tests/test_bounce_pallas.py
    (``_glossy_box_scene``): the box above plus a conductor, a dielectric
    and a rough-conductor panel, built with either package."""
    b = make_box(scene_mod, shapes_mod, width, height)
    mirror = b.add_bsdf(scene_mod.BSDF_CONDUCTOR, eta=0.2, k=[3.9, 2.45, 2.14])
    glass = b.add_bsdf(scene_mod.BSDF_DIELECTRIC, eta=1.5)
    rough = b.add_bsdf(scene_mod.BSDF_ROUGHCONDUCTOR, alpha=0.25, eta=0.2,
                       k=[3.9, 2.45, 2.14])

    def panel(translate, ry, bsdf):
        m = np.eye(4)
        m[:3, :3] = np.diag([0.35, 0.35, 1.0])
        rot = np.eye(4)
        a = np.deg2rad(ry)
        rot[0, 0] = rot[2, 2] = np.cos(a)
        rot[0, 2] = np.sin(a)
        rot[2, 0] = -np.sin(a)
        out = rot @ m
        out[:3, 3] = translate
        b.add_shape(shapes_mod.make_rectangle(out, False), bsdf)

    panel([-0.95, 1.0, 0.2], 90, mirror)
    panel([0.95, 0.7, -0.2], -90, rough)
    panel([0.0, 0.6, 0.3], 10, glass)
    return b


def make_tiled_box(scene_mod, shapes_mod, width=24, height=24, n_panels=52):
    """The box of tests/test_bounce_pallas.py ``_tiled_box_scene``: the box
    above plus a grid of small coloured panels on the back wall, past the
    96-triangle limit of the unrolled sweep (116 triangles)."""
    b = make_box(scene_mod, shapes_mod, width, height)
    for i in range(n_panels):
        r, c = divmod(i, 8)
        bsdf = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[
            0.2 + 0.6 * (i % 3 == 0), 0.2 + 0.6 * (i % 3 == 1),
            0.2 + 0.6 * (i % 3 == 2)])
        m = np.eye(4)
        m[:3, :3] = np.diag([0.09, 0.09, 1.0])
        m[:3, 3] = [-0.9 + 0.25 * c, 0.15 + 0.25 * r, -0.98]
        b.add_shape(shapes_mod.make_rectangle(m, False), bsdf)
    return b


def make_sphere_box(scene_mod, shapes_mod, width=16, height=16,
                    n_spheres=6, res=10):
    """The scene of tests/test_clas_pallas.py ``_scene``: the box above plus
    ``n_spheres`` diffuse spheres of ``res`` x 2 ``res`` quads at seeded
    centres and radii (2,172 triangles at the defaults), built with either
    package."""
    b = make_box(scene_mod, shapes_mod, width, height)
    rng = np.random.default_rng(3)
    white = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.5] * 3)
    for _ in range(n_spheres):
        c = rng.uniform([-0.8, 0.1, -0.8], [0.8, 1.8, 0.8])
        b.add_shape(shapes_mod.make_sphere(c, rng.uniform(0.1, 0.3),
                                           np.eye(4), n_theta=res,
                                           n_phi=2 * res), white)
    return b


def random_rays(v0, n, seed=0):
    """n rays as numpy: origins uniform in the triangles' v0 bounds grown by
    0.1, unit directions, and t_max INF on half of them and in [0.2, 2) on
    the other half."""
    rs = np.random.RandomState(seed)
    lo = v0.min(0) - 0.1
    hi = v0.max(0) + 0.1
    ro = (rs.rand(n, 3) * (hi - lo) + lo).astype(np.float32)
    rd = rs.randn(n, 3)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.where(rs.rand(n) < 0.5, 3.4e38,
                     rs.uniform(0.2, 2.0, n)).astype(np.float32)
    return ro, rd, t_max


def doubled_spheres(seed=5):
    """Six spheres of 10 x 20 quads with every triangle twice, as float32
    numpy (v0, e1, e2), and the number of distinct triangles (the copies
    come after them). A triangle and its copy share a Morton code, so they
    sit side by side in the cluster build's order."""
    from sdmm_tpu_torch.scene import shapes

    rng = np.random.default_rng(seed)
    v = np.concatenate([shapes.make_sphere(
        rng.uniform(-0.8, 0.8, 3), rng.uniform(0.15, 0.35), n_theta=10,
        n_phi=20).concat()[0] for _ in range(6)])
    n_t = v.shape[0]
    v = np.concatenate([v, v])
    return (v[:, 0].astype(np.float32), (v[:, 1] - v[:, 0]).astype(np.float32),
            (v[:, 2] - v[:, 0]).astype(np.float32)), n_t


def rays_at(tris, n, seed):
    """n rays as numpy (ro, rd) from uniform points of [-1.2, 1.2]^3 toward
    the centroids of random triangles of ``tris``."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-1.2, 1.2, (n, 3))
    k = rs.randint(0, tris[0].shape[0], n)
    d = tris[0][k] + (tris[1][k] + tris[2][k]) / 3.0 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def grazing_rays(v0, e1, e2, n, seed):
    """n rays as float32 numpy (ro, rd) that graze the triangles v0, e1, e2
    (float64 numpy [T, 3]): rays from uniform points of [-1, 1]^3 + (0, 1,
    0) toward points on random triangles' edges (u = 0, v = 0 or u + v = 1
    up to rounding); and, on even rays whose triangle is axis-aligned,
    rays almost in its plane, with det = dn * (e1 x e2)[axis] at 0.5e-12
    to 2e-12 on both sides of the sweep's 1e-12 test."""
    rs = np.random.RandomState(seed)
    k = rs.randint(0, v0.shape[0], n)
    a = rs.rand(n)[:, None]
    edge = rs.randint(0, 3, n)[:, None]
    p = v0[k] + np.where(edge == 0, a * e2[k], np.where(
        edge == 1, a * e1[k], a * e1[k] + (1 - a) * e2[k]))
    o = rs.uniform(-1.0, 1.0, (n, 3)) + np.array([0.0, 1.0, 0.0])
    d = p - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = np.cross(e1[k], e2[k])
    axis = np.abs(nrm).argmax(-1)
    flat = np.isclose(np.abs(nrm).max(-1), np.linalg.norm(nrm, axis=-1))
    half = (np.arange(n) % 2 == 0) & flat
    c = rs.uniform(0.5, 2.0, n) * np.where(rs.rand(n) < 0.5, -1.0, 1.0)
    dn = -c * 1e-12 / nrm[np.arange(n), axis]
    d[half] = rs.randn(int(half.sum()), 3)
    d[half, axis[half]] = 0.0
    d[half] /= np.linalg.norm(d[half], axis=-1, keepdims=True)
    d[half, axis[half]] = dn[half]
    return o.astype(np.float32), d.astype(np.float32)


def defer_pretest(ro, rd, lim, v0, e1, e2):
    """Plain model of csrc/mt_sweep.cu's pre-test of the warp-voted kernel
    (mt_pair<true>), in its order of float32 operations, for rays ro, rd
    [N, 3] with limits lim [N] against triangles [T, 3]: bool [N, T], True
    where the pair may hit. The kernel's proof says it is True on every
    pair that the final test accepts."""
    rdx, rdy, rdz = (rd[:, i:i + 1] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx, ty, tz = (ro[:, i:i + 1] - v0[None, :, i] for i in range(3))
    u = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = rdx * qx + rdy * qy + rdz * qz
    t = e2x * qx + e2y * qy + e2z * qz
    a = det.abs()
    neg = det < 0.0
    us, vs, ts = (torch.where(neg, -x, x) for x in (u, v, t))
    slack = -(a * 2.0 ** -100)
    return ((a > 1e-12) & (us >= slack) & (vs >= slack) & (ts > 0.0)
            & (us + vs <= a * 1.0001) & (ts <= lim[:, None] * a * 1.0001))


def _slabs(lo, hi, o, inv):
    """The kernel's slab test of boxes lo, hi [..., 3, M] for rays o, inv
    [..., 3, 1] in float32: (entry, exit) [..., M]."""
    a0, a1 = (lo - o) * inv, (hi - o) * inv
    return torch.minimum(a0, a1).amax(-2), torch.maximum(a0, a1).amin(-2)


def _safe_inv(rd):
    good = rd.abs() > 1e-12
    return 1.0 / torch.where(good, rd, torch.where(rd >= 0, 1e-12, -1e-12))


def admitted_tests(ro, rd, t_max, t_final, aabb, ids, chunk=8192):
    """The Woop tests the least culling design needs, per query (float64
    [N]): the real triangles of every cluster whose box the query enters
    before min(its final hit distance, t_max), with the kernel's slab
    test."""
    c = ids.shape[0]
    real = (ids >= 0).sum(1).double()
    lo, hi = aabb[0:3, :c], aabb[3:6, :c]
    limit = torch.minimum(t_final, t_max)
    inv = _safe_inv(rd)
    out = []
    for s in range(0, ro.shape[0], chunk):
        tmin, tmx = _slabs(lo[None], hi[None], ro[s:s + chunk, :, None],
                           inv[s:s + chunk, :, None])  # [n, C]
        enter = (tmx >= tmin.clamp_min(0.0)) \
            & (tmin < limit[s:s + chunk, None])
        out.append(enter.double() @ real)
    return torch.cat(out)


def least_slab_tests(ro, rd, t_max, t_final, tree, chunk=8192):
    """The slab tests the least walk of the cluster tree (ops/clas_cull
    ``build_tree`` [2P, 8]) needs, per query (float64 [N]): the two child
    tests of every inner node whose box the query enters before min(its
    final hit distance, t_max), with the kernel's slab test. Any walk that
    finds the hit opens these nodes."""
    inner = tree[1:tree.shape[0] // 2]
    lo, hi = inner[:, 0:3].T, inner[:, 4:7].T
    full = (inner[:, 0] <= inner[:, 4]).double()
    limit = torch.minimum(t_final, t_max)
    inv = _safe_inv(rd)
    out = []
    for s in range(0, ro.shape[0], chunk):
        tmin, tmx = _slabs(lo[None], hi[None], ro[s:s + chunk, :, None],
                           inv[s:s + chunk, :, None])  # [n, P - 1]
        enter = (tmx >= tmin.clamp_min(0.0)) \
            & (tmin < limit[s:s + chunk, None])
        out.append(2.0 * (enter.double() @ full))
    return torch.cat(out)


def tree_walk(ro, rd, t_max, tree, woop, ids):
    """Plain PyTorch model of the walk of csrc/clas_cull.cu, one ray at a
    time on CPU tensors: the tree of ops/clas_cull.build_tree [2P, 8],
    nearer child first (the lower index on equal entries), a node entered
    when lo <= hi, exit >= max(entry, 0), entry <= best t and entry <
    t_max, a stacked node popped only while its entry is still <= the best
    t, and a cluster's slots swept in order with the tie rule
    t < best_t or (t == best_t and code < best code). Woop rows [C, 12,
    t_c]. Returns (t, tri, u, v) as ops/clas_cull.cull does, the real slots
    each ray swept (int64 [N]), how often the tie rule's second clause
    replaced a ray's best (int64 [N]) and the inner nodes each ray opened,
    two slab tests each (int64 [N])."""
    from sdmm_tpu_torch.ops import bounce as bo

    inf = float(np.float32(bo.INF))  # the kernel's best t before a hit
    n = ro.shape[0]
    c, _, t_c = woop.shape
    leaves = tree.shape[0] // 2
    real = (ids >= 0).sum(1)
    # Every slot's hit distance for every ray, as the twin computes it:
    # INF where there is no hit within (EPS, t_max).
    cols = woop.permute(1, 0, 2).reshape(12, -1)
    t_all, u_all, v_all, ok = bo._woop_tri(
        *ro.unbind(1), *rd.unbind(1), cols[:, :, None], slice(None))
    t_all = torch.where(ok & (t_all > bo.EPS) & (t_all < t_max), t_all,
                        bo.INF)  # [C * t_c, N]
    entry, exit_ = _slabs(tree[None, :, 0:3].transpose(1, 2),
                          tree[None, :, 4:7].transpose(1, 2), ro[:, :, None],
                          _safe_inv(rd)[:, :, None])  # [N, 2P]
    empty = (tree[:, 0] > tree[:, 4]).tolist()
    out_t = torch.full((n,), bo.INF)
    out_tri = torch.full((n,), -1, dtype=torch.int32)
    out_u, out_v = torch.zeros(n), torch.zeros(n)
    swept = torch.zeros(n, dtype=torch.int64)
    ties = torch.zeros(n, dtype=torch.int64)
    opened = torch.zeros(n, dtype=torch.int64)
    for r in range(n):
        e, x, tm = entry[r].tolist(), exit_[r].tolist(), float(t_max[r])
        best_t, code, stack, node = inf, -1, [], 1

        def enters(k):
            return (not empty[k] and x[k] >= max(e[k], 0.0)
                    and e[k] <= best_t and e[k] < tm)

        def pop():
            while stack:
                k = stack.pop()
                if e[k] <= best_t:
                    return k
            return 0

        while node:
            if node < leaves:
                opened[r] += 1
                c0, c1 = 2 * node, 2 * node + 1
                h0, h1 = enters(c0), enters(c1)
                if h0 and h1:
                    near, far = (c1, c0) if e[c1] < e[c0] else (c0, c1)
                    stack.append(far)
                    node = near
                elif h0 or h1:
                    node = c0 if h0 else c1
                else:
                    node = pop()
                continue
            cl = node - leaves
            swept[r] += int(real[cl])
            ts = t_all[cl * t_c:(cl + 1) * t_c, r]
            j = int(ts.argmin())  # the first minimum of the cluster
            t, k = float(ts[j]), cl * t_c + j
            if t < best_t or (t == best_t and k < code):
                ties[r] += int(t == best_t)
                best_t, code = t, k
                out_u[r], out_v[r] = u_all[k, r], v_all[k, r]
            node = pop()
        if code >= 0:
            out_t[r], out_tri[r] = best_t, ids.reshape(-1)[code]
    return out_t, out_tri, out_u, out_v, swept, ties, opened


def path_wave(n, seed=0, width=16, height=16, max_depth=5, budget=5):
    """A wave of n lanes for the fused unguided step, as numpy: the
    ``lane_wave`` state and meta (the meta's pixel field read as a sample
    count below ``budget``) with a previous-bounce pdf in state row 13 and
    delta flags in 30% of the metas; pxpy [3, n] (a pixel and a sample
    budget in [0, budget)), a film [8, n] to add to, rand [10, n]."""
    from sdmm_tpu_torch.ops import bounce as bo

    state, meta, _ = lane_wave(n, seed=seed, n_pix=budget,
                               max_depth=max_depth)
    rs = np.random.RandomState(seed + 1)
    state[13] = rs.uniform(0.05, 3.0, n)
    meta |= np.where(rs.rand(n) < 0.3, bo._PDELTA, 0).astype(np.int32)
    pxpy = np.stack([rs.randint(0, width, n), rs.randint(0, height, n),
                     rs.randint(0, budget, n)]).astype(np.float32)
    film = rs.uniform(0.0, 1.0, (8, n)).astype(np.float32)
    rand = rs.rand(bo.STEP_RAND_ROWS, n).astype(np.float32)
    return state, meta, film, pxpy, rand


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_scene_arrays(scene) -> dict:
    return {k: np.asarray(v) for k, v in scene._asdict().items()}


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def sdmm_to_torch(sdmm) -> tmix.SDMM:
    return tmix.SDMM(weight=t(sdmm.weight), mean=t(sdmm.mean), cov=t(sdmm.cov))


def make_mixture_state(seed=0, L=8, K=16):
    """Anisotropic, unequal-weight mixtures with a few dead components per
    leaf (the state recipe of tests/test_guided_pallas.py), as numpy."""
    import jax
    import jax.numpy as jnp

    from sdmm_tpu.guiding import init as init_mod

    rs = np.random.RandomState(seed)
    lo = jnp.asarray(np.zeros((L, 3), np.float32))
    hi = jnp.asarray((np.ones((L, 3)) * rs.rand(L, 1)).astype(np.float32)
                     + 0.5)
    sdmm = init_mod.init_leaf_params(jax.random.PRNGKey(seed), lo, hi, K)
    w = rs.dirichlet(np.ones(K), size=L).astype(np.float32)
    w = np.where(rs.rand(L, K) < 0.2, 0.0, w)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
    jitter = rs.randn(L, K, 5, 5).astype(np.float32) * 0.01
    cov = np.asarray(sdmm.cov) + 0.5 * (jitter + np.swapaxes(jitter, -1, -2))
    initialized = rs.rand(L) < 0.9
    return {"weight": w.astype(np.float32),
            "mean": np.asarray(sdmm.mean, np.float32),
            "cov": cov.astype(np.float32), "initialized": initialized}


def guided_rows(st, weight=None, initialized=None):
    """The port's [353, L] guided-sampling rows of a make_mixture_state
    state (``weight`` and ``initialized`` replace the state's)."""
    w = st["weight"] if weight is None else weight
    ini = st["initialized"] if initialized is None else initialized
    ts = tmix.SDMM(weight=t(w), mean=t(st["mean"]), cov=t(st["cov"]))
    return tgs.pack_guided_rows(tmix.prepare(ts), ts.weight,
                                torch.as_tensor(ini))


def guided_lanes(seed, L, N):
    """Guided-sampling lanes: leaf ids, positions, unit BSDF directions and
    uniforms, float32 numpy."""
    rs = np.random.RandomState(seed)
    leaf = rs.randint(0, L, size=N).astype(np.int32)
    pos = rs.rand(N, 3).astype(np.float32)
    wob = rs.randn(N, 3).astype(np.float32)
    wob /= np.linalg.norm(wob, axis=-1, keepdims=True)
    u = rs.rand(N, 3).astype(np.float32)
    return leaf, pos, wob, u


def lane_wave(n, seed=0, n_pix=256, max_depth=5):
    """A wave of n lanes for the fused bounce kernels, as numpy: state
    [16, n] (a quarter camera rays into the box, the rest from random
    points inside it in random directions; random throughput, radiance and
    eta², a few NaN radiances), meta [n] (random pixel and depth, 85%
    alive, 10% exhausted) and rand [8, n]."""
    from sdmm_tpu_torch.ops import bounce as bo

    rs = np.random.RandomState(seed)
    lo = np.array([-0.95, 0.05, -0.95])
    o = rs.rand(n, 3) * 1.9 + lo
    d = rs.randn(n, 3)
    cam = rs.rand(n) < 0.25
    o[cam] = [0.0, 1.0, 4.0]
    d[cam] = (rs.rand(n, 3) * 1.8 + lo)[cam] - o[cam]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    state = np.zeros((16, n), np.float32)
    state[0:3] = o.T
    state[3:6] = d.T
    state[6:9] = rs.uniform(0.2, 1.5, (3, n))
    state[9:12] = rs.uniform(0.0, 2.0, (3, n))
    state[9, ::97] = np.nan
    state[12] = rs.uniform(0.5, 2.0, n)
    meta = (rs.randint(0, n_pix, n)
            | rs.randint(0, max_depth, n) << bo._DEPTH_SHIFT
            | np.where(rs.rand(n) < 0.85, bo._ALIVE, 0)
            | np.where(rs.rand(n) < 0.1, bo._EXH, 0)).astype(np.int32)
    return state, meta, rs.rand(8, n).astype(np.float32)


def posterior_fault_batch(seed=3, n=600):
    """E-step inputs (numpy) with two valid samples whose posterior is not
    finite in float32, among n ordinary ones over three leaves of 16
    components: in leaf 0 a sample at the mean of a component whose
    covariance is 1e-16·I (its pdf overflows), and in leaf 1, whose
    only live component has covariance 0.01·I, a sample so far from it that
    the posterior total (~5e-40) has no finite reciprocal. Returns (weight
    [L, K], mean [L, K, 6], cov [L, K, 5, 5], pos, d, w, leaf, L)."""
    L, K = 3, 16
    rs = np.random.RandomState(seed)
    weight = rs.dirichlet(np.ones(K), size=L).astype(np.float32)
    dirs = rs.randn(L, K, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mean = np.concatenate([rs.rand(L, K, 3), dirs], -1).astype(np.float32)
    jit = rs.randn(L, K, 5, 5) * 0.005
    cov = (0.05 * np.eye(5) + 0.5 * (jit + np.swapaxes(jit, -1, -2)))
    cov[0, 0] = 1e-16 * np.eye(5)
    weight[1] = 0.0
    weight[1, 0] = 1.0
    mean[1, 0] = [0.5, 0.5, 0.5, 0.0, 0.0, 1.0]
    cov[1, 0] = 0.01 * np.eye(5)
    pos = rs.rand(n, 3).astype(np.float32)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = (rs.rand(n) * 2.0).astype(np.float32)
    # Leaf 1 holds the far sample alone: ordinary samples there would give
    # totals in float32's subnormal range, which XLA's CPU backend flushes
    # to zero and PyTorch keeps.
    leaf = rs.choice([0, 2], size=n).astype(np.int32)
    # pdf = (2π)^-5/2 · 1e5 · exp(-q/2) = 5e-40 at q = r² / 0.01.
    r = np.sqrt(0.02 * np.log((2 * np.pi) ** -2.5 * 1e5 / 5e-40))
    pos[0], d[0], leaf[0] = mean[0, 0, :3], mean[0, 0, 3:], 0
    pos[1], d[1], leaf[1] = [0.5 + r, 0.5, 0.5], [0.0, 0.0, 1.0], 1
    return (weight, mean, cov.astype(np.float32), pos, d.astype(np.float32),
            w, leaf, L)


def make_media_box(scene_mod, shapes_mod, width=16, height=16, fog=True,
                   hetero=True, dipole=False, grid_seed=7):
    """The box of ``make_box`` with participating media, built with either
    package: a scene-level fog (``fog``: mean free path ~2.5 box units,
    albedo 0.8, g 0.3); a dielectric sphere whose interior is a medium,
    heterogeneous (``hetero``: an 8³ random density grid over the sphere's
    bounds, sigma_t 3) or homogeneous; with ``dipole`` a subsurface block
    of explicit coefficients (4 irradiance samples)."""
    b = make_box(scene_mod, shapes_mod, width, height)
    if fog:
        b.medium = {"sigma_t": np.array([0.4, 0.4, 0.4]),
                    "albedo": np.array([0.8, 0.8, 0.8]), "g": 0.3}
    if hetero:
        grid = np.random.RandomState(grid_seed).rand(8, 8, 8)
        inner = b.add_medium([3.0, 3.0, 3.0], [0.9, 0.7, 0.5], -0.2,
                             density=grid.astype(np.float32),
                             vol_lo=[-0.35, 0.25, -0.35],
                             vol_hi=[0.35, 0.95, 0.35])
    else:
        inner = b.add_medium([1.5, 2.0, 2.5], [0.9, 0.8, 0.7], 0.5)
    glass = b.add_bsdf(scene_mod.BSDF_DIELECTRIC, eta=1.33)
    b.add_shape(shapes_mod.make_sphere([0.0, 0.6, 0.0], 0.35, n_theta=8,
                                       n_phi=16), glass, interior=inner)
    if dipole:
        sss = b.add_subsurface([8.0, 8.0, 8.0], [0.12, 0.24, 0.48],
                               eta=1.3, irr_samples=4)
        b.add_shape(shapes_mod.make_cube(
            compose([0.5, 0.2, 0.4], [0.15, 0.2, 0.15], ry=20)), 0, sss=sss)
    return b


def film_mean_se(raw, sqr, weight):
    """The mean of a film's image and its standard error, from the film's
    sum, sum of squares and sample count per pixel (numpy). The channels
    are taken as fully correlated, which bounds the error from above."""
    n = np.maximum(np.asarray(weight, np.float64), 1.0)[..., None]
    mean = np.asarray(raw, np.float64) / n
    var = np.maximum(np.asarray(sqr, np.float64) / n - mean * mean, 0.0) / n
    sd = np.sqrt(var).mean(-1).ravel()
    return float(mean.mean()), float(np.sqrt((sd * sd).sum()) / sd.size)


def within_se(a, b, k=4.0):
    """Whether two (mean, standard error) pairs lie within k joint
    standard errors."""
    return abs(a[0] - b[0]) <= k * float(np.hypot(a[1], b[1]))


# A weave with both yarn kinds of the Irawan model: staple yarns (psi != 0)
# and filament yarns (psi 0, with a smoothstep ss > 0), warp and weft, and a
# kappa on either side of 0, in a 3x2 tile; $names come from the BSDF's
# properties.
TEST_WEAVE = """
/* a test weave */
weave {
    name = "twill-ish", // a comment
    alpha = $alpha, beta = 2.5, ss = 0.2, hWidth = 0.5,
    warpArea = 0.6, weftArea = 0.4,
    tileWidth = 3, tileHeight = 2,
    pattern { 1, 2, 3,
              4, 1, 2 },
    yarn { type = warp, psi = 0, umax = 35, kappa = 0.3,
           width = 1, length = 2, centerU = 0.2, centerV = 0.3,
           kd = {0.3, 0.2, 0.1}, ks = {$ks, 0.5, 0.4} },
    yarn { type = weft, psi = 25, umax = 50, kappa = -0.4,
           width = 1, length = 1.5, centerU = 0.5, centerV = 0.25,
           kd = {0.2, 0.3, 0.1}, ks = {0.4, 0.4, 0.4} },
    yarn { type = warp, psi = 30, umax = 40, kappa = 0,
           width = 0.8, length = 1.2, centerU = 0.8, centerV = 0.7,
           kd = {0.5, 0.4, 0.3}, ks = {0.3, 0.3, 0.3} },
    yarn { type = weft, psi = 0, umax = 30, kappa = -0.2,
           width = 1, length = 3, centerU = 0.4, centerV = 0.6,
           kd = {0.1, 0.1, 0.2}, ks = {0.6, 0.5, 0.5} }
}
"""
TEST_WEAVE_PARAMS = {"alpha": 0.2, "ks": 0.7}


def irawan_norm_draws(n=10_000, seed=0):
    """The reference's specular_normalization draws (wi, wo, uv) as numpy:
    two cosine-sampled directions and a uniform uv from
    jax.random.PRNGKey(seed) split in three, as sdmm_tpu/bsdf/irawan.py
    draws them."""
    import jax

    from sdmm_tpu.core import warp as jwarp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    wi = jwarp.square_to_cosine_hemisphere(jax.random.uniform(k1, (n, 2)))
    wo = jwarp.square_to_cosine_hemisphere(jax.random.uniform(k2, (n, 2)))
    return (np.asarray(wi), np.asarray(wo),
            np.asarray(jax.random.uniform(k3, (n, 2))))


def make_irawan_box(scene_mod, shapes_mod, irawan_mod, width=16, height=16,
                    weave=None, params=None):
    """make_box with its back wall woven (the pattern repeated 6 times
    across the wall's uv) and its ceiling white."""
    b = make_box(scene_mod, shapes_mod, width, height)
    wp = irawan_mod.parse_weave(weave or irawan_mod.PLAIN_WEAVE, params)
    wp.repeat_u = wp.repeat_v = 6.0
    b.irawan_pattern = wp
    cloth = b.add_bsdf(scene_mod.BSDF_IRAWAN)
    soup, _, em = b.soups[2][:3]
    b.soups[2] = (soup, cloth, em) + tuple(b.soups[2][3:])
    return b
