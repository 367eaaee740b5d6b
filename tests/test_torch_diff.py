"""Port parity of differentiable rendering (diff/inverse.py and what it
differentiates through): the hits that render/intersect.intersect
re-attaches to autograd behind the intersection routes, against jax.grad
through the reference's XLA sweep on the same rays; _clean_cotangent;
bsdf.sample_full's gradients in albedo and GGX alpha on the same uniforms;
torch.optim.Adam with the roughness clamp against optax.adam; and
tests/test_diff.py's finite-difference checks through the port's
make_render_fn, with the hits detached as the card's kernels return them,
plus an analytic case of the detached Russian-roulette probability.
Tolerances: rtol 1e-4 for the hits and the BSDF gradients (float32);
Adam within 1e-5 (20 float32 steps of 0.04, whose two packages order the
bias corrections differently); the FD checks keep tests/test_diff.py's 8%
and 5%."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, make_rough_box, rays_at, to_np  # noqa: E402

from sdmm_tpu.bsdf import bsdf as jbsdf  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import bsdf as tbsdf  # noqa: E402
from sdmm_tpu_torch.diff import inverse  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import volpath as tvolpath  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)


def test_reattached_hits_match_the_reference_sweep_gradients():
    """t, u, v and their vector-Jacobian products in ro and rd on 4,096
    rays into the box: the port's route runs outside autograd and
    intersect re-attaches the winning triangle's Möller–Trumbore; the
    reference differentiates its XLA sweep's pick. _clean_cotangent is
    the identity forward and zeroes non-finite cotangents."""
    js, _ = make_box(jscene, jshapes).build()
    ts, _ = make_box(tscene, tshapes).build(device="cpu")
    tris = tuple(to_np(a) for a in (ts.tri_v0, ts.tri_e1, ts.tri_e2))
    ro, rd = rays_at(tris, 4096, seed=3)
    rs = np.random.RandomState(4)
    cts = rs.randn(3, 4096).astype(np.float32)

    def j_f(o, d):
        h = jisect.intersect(js, o, d)
        return tuple(jnp.where(h["valid"], h[k], 0.0) for k in "tuv"), h

    jt, j_vjp, jh = jax.vjp(j_f, jnp.asarray(ro), jnp.asarray(rd),
                            has_aux=True)
    j_dro, j_drd = j_vjp(tuple(jnp.asarray(c) for c in cts))

    tro = torch.as_tensor(ro).requires_grad_(True)
    trd = torch.as_tensor(rd).requires_grad_(True)
    th = tisect.intersect(ts, tro, trd)
    np.testing.assert_array_equal(to_np(th["tri"]), np.asarray(jh["tri"]))
    valid = th["valid"]
    assert 0.5 < float(valid.float().mean()) <= 1.0
    total = 0.0
    for k, jv, c in zip("tuv", jt, cts):
        tv = torch.where(valid, th[k], 0.0)
        np.testing.assert_allclose(to_np(tv), np.asarray(jv), rtol=1e-4,
                                   atol=1e-6)
        total = total + (tv * torch.as_tensor(c)).sum()
    total.backward()
    for got, want in ((tro.grad, j_dro), (trd.grad, j_drd)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # Outside autograd the hit is the route's own record.
    plain = tisect.intersect(ts, torch.as_tensor(ro), torch.as_tensor(rd))
    for k in ("t", "u", "v", "tri", "valid"):
        assert torch.equal(plain[k], th[k].detach()), k

    x = torch.tensor([1.0, -2.0, 3.0, 4.0], requires_grad=True)
    y = tvolpath._clean_cotangent(x)
    assert torch.equal(y, x.detach())
    y.backward(torch.tensor([float("nan"), float("inf"), -float("inf"),
                             0.5]))
    assert torch.equal(x.grad, torch.tensor([0.0, 0.0, 0.0, 0.5]))


def _sample_inputs(n=2048, seed=5):
    rs = np.random.RandomState(seed)
    wi = rs.randn(2 * n, 3)
    wi[:, 2] = np.abs(wi[:, 2]) + 0.05
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    u = rs.rand(4, 2 * n).astype(np.float32)
    cts = [rs.randn(2 * n, 3).astype(np.float32),
           rs.randn(2 * n, 3).astype(np.float32),
           rs.randn(2 * n).astype(np.float32)]
    return wi, u, cts


def test_bsdf_sample_and_adam_gradients_match_the_reference():
    """The vector-Jacobian product of sample_full's weight, wo and pdf in
    the BSDF table's albedo and alpha, on the rough box's diffuse and rough
    conductor rows at the same uniforms; then torch.optim.Adam against
    optax.adam over 20 fixed gradients, bsdf_alpha clamped to
    ALPHA_RANGE after every step as optimize_parameters does."""
    js, jcfg = make_rough_box(jscene, jshapes).build()
    ts, tcfg = make_rough_box(tscene, tshapes).build(device="cpu")
    rough = int(ts.bsdf_alpha.shape[0]) - 1
    n = 2048
    idx = np.repeat(np.asarray([0, rough], np.int32), n)
    wi, u, cts = _sample_inputs(n)
    u2 = np.ascontiguousarray(u[2:4].T)
    types = tuple(tcfg.bsdf_types)

    def j_f(albedo, alpha):
        s = js._replace(bsdf_albedo=albedo, bsdf_alpha=alpha)
        p = jbsdf.gather_params(s, jnp.asarray(idx), types=types)
        out = jbsdf.sample_full(p, jnp.asarray(wi), jnp.asarray(u[0]),
                                jnp.asarray(u[1]), jnp.asarray(u2),
                                types=types)
        return out["weight"], out["wo"], out["pdf"]

    _, j_vjp = jax.vjp(j_f, js.bsdf_albedo, js.bsdf_alpha)
    j_ga, j_gr = j_vjp(tuple(jnp.asarray(c) for c in cts))

    albedo = ts.bsdf_albedo.clone().requires_grad_(True)
    alpha = ts.bsdf_alpha.clone().requires_grad_(True)
    s = ts._replace(bsdf_albedo=albedo, bsdf_alpha=alpha)
    p = tbsdf.gather_params(s, torch.as_tensor(idx), types=types)
    out = tbsdf.sample_full(p, torch.as_tensor(wi), torch.as_tensor(u[0]),
                            torch.as_tensor(u[1]), torch.as_tensor(u2),
                            types=types)
    sum((out[k] * torch.as_tensor(c)).sum()
        for k, c in zip(("weight", "wo", "pdf"), cts)).backward()
    for got, want in ((albedo.grad, j_ga), (alpha.grad, j_gr)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0.0
        np.testing.assert_allclose(to_np(got), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())

    rs = np.random.RandomState(6)
    grads = [{"bsdf_albedo": rs.randn(5, 3).astype(np.float32),
              "bsdf_alpha": 3.0 * rs.randn(5).astype(np.float32)}
             for _ in range(20)]
    init = {"bsdf_albedo": to_np(ts.bsdf_albedo),
            "bsdf_alpha": to_np(ts.bsdf_alpha)}
    opt = optax.adam(0.04)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)
    tp = {k: torch.as_tensor(v).clone().requires_grad_(True)
          for k, v in init.items()}
    topt = torch.optim.Adam(list(tp.values()), lr=0.04)
    lo, hi = inverse.ALPHA_RANGE
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state)
        jp = optax.apply_updates(jp, upd)
        jp["bsdf_alpha"] = jnp.clip(jp["bsdf_alpha"], lo, hi)
        for k, v in tp.items():
            v.grad = torch.as_tensor(g[k])
        topt.step()
        inverse.clamp_roughness(tp)
        for k in tp:
            np.testing.assert_allclose(to_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-5)
    assert float(tp["bsdf_alpha"].detach().min()) == np.float32(lo)


def _rr_scene():
    """A grey diffuse wall of albedo 0.5 filling the view under a constant
    environment of radiance 2: max depth 2, roulette from the first
    bounce."""
    b = tscene.SceneBuilder()
    grey = b.add_bsdf(tscene.BSDF_DIFFUSE, albedo=[0.5, 0.5, 0.5])
    wall = np.diag([50.0, 50.0, 1.0, 1.0])
    wall[2, 3] = -1.0
    b.add_shape(tshapes.make_rectangle(wall), grey)
    b.env_radiance = np.array([2.0, 2.0, 2.0])
    cam = np.eye(4)
    cam[0, 0] = cam[2, 2] = -1.0
    cam[2, 3] = 3.0
    b.set_sensor(cam, fov_deg=40.0, width=8, height=8)
    b.max_depth = 2
    b.rr_depth = 1
    return b.build(device="cpu")


def test_finite_differences_through_make_render_fn():
    """tests/test_diff.py's checks on the port: the albedo gradient is
    finite, positive on the white walls and within 8% of the same-seed
    central difference (eps 3e-2); the roughness gradient within 5% (eps
    5e-3). The route's hits are detached, as the card's kernels return
    them: without intersect's re-attachment the roughness gradient misses.
    Then Russian roulette: on the grey wall at rr_depth 1 a surviving lane
    carries thr/q = 1, so with q detached d li/d a = li/a, where an
    undetached q would give 0."""
    scene, cfg = make_rough_box(tscene, tshapes).build(device="cpu")
    pix = torch.arange(cfg.width * cfg.height)

    g = inverse.pixel_gradients(scene, cfg, pix, "bsdf_albedo", 0, spp=2,
                                device="cpu")
    assert g.shape == scene.bsdf_albedo.shape and bool(g.isfinite().all())
    assert float(g[0].sum()) > 0.0

    def check(name, seed, entry, eps, tol):
        render = inverse.make_render_fn(scene, cfg, pix, name, spp=4,
                                        device="cpu")
        base = getattr(scene, name)
        p = base.clone().requires_grad_(True)
        render(p, seed).mean().backward()
        assert bool(p.grad.isfinite().all())
        e = torch.zeros_like(base)
        e[entry] = eps
        with torch.no_grad():
            fd = float(render(base + e, seed).mean()
                       - render(base - e, seed).mean()) / (2 * eps)
        got = float(p.grad[entry])
        assert abs(got - fd) / max(abs(fd), 1e-8) < tol, (name, got, fd)

    check("bsdf_albedo", 3, (0, 1), 3e-2, 0.08)
    check("bsdf_alpha", 7, int(scene.bsdf_alpha.shape[0]) - 1, 5e-3, 0.05)

    rr, rr_cfg = _rr_scene()
    a = rr.bsdf_albedo.clone().requires_grad_(True)
    img = inverse.make_render_fn(rr, rr_cfg, torch.arange(64),
                                 "bsdf_albedo", spp=4, nee=False,
                                 device="cpu")(a, 1)
    # Each lane's radiance is 2 where it survived the roulette, else 0.
    assert 0.5 < float(img.detach().mean()) < 1.5
    img.mean().backward()
    want = float(img.detach().mean()) / (3 * 0.5)
    np.testing.assert_allclose(to_np(a.grad[0]), want, rtol=1e-5)
