"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py):
the same scenes and mixture states built from numpy for both packages."""

import numpy as np
import torch

from sdmm_tpu_torch.guiding import mixture as tmix


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
