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
