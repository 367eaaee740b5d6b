"""Learned-BSDF product sampling, sdmm_tpu_torch vs sdmm_tpu: the directional
EM fit from the same initial components (rtol 1e-4: 30 iterations of
float32 sums in a different order), the top-k pruning, the mixture product
and the rotation of a learned table into the world frame on the same
inputs (rtol 1e-5), .sdmm files both ways; the port's table on the
four-type box; and product training on that box, whose image agrees with
the port's NEE render in expectation (4 standard errors) without
launching guided_sample."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import film_mean_se, make_box, to_np, within_se  # noqa

from sdmm_tpu.guiding import io as jio  # noqa: E402
from sdmm_tpu.guiding import learned_bsdf as jlb  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.guiding import tangent as jtg  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import io as tio  # noqa: E402
from sdmm_tpu_torch.guiding import learned_bsdf as tlb  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as tgs  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.render.wavefront import render_wavefront  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-5  # the same float32 operations in both packages
ATOL = 1e-5  # times max(1, |max|): the compiled reference reassociates
FIT_RTOL = 1e-4  # the iterative fit: sums in another order, 30 times


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _conditionals(n, k, seed, spread):
    """The same random directional conditional in both packages: means in
    the upper hemisphere within ``spread`` of +z, PD covariances."""
    rs = np.random.RandomState(seed)
    mu = _unit(np.concatenate([spread * rs.randn(n, k, 2),
                               np.ones((n, k, 1))], -1))
    a = rs.randn(n, k, 2, 2) * 0.3
    cov = a @ np.swapaxes(a, -1, -2) + 0.05 * np.eye(2)
    chol = np.linalg.cholesky(cov).astype(np.float32)
    w = rs.rand(n, k)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    rot = np.asarray(jtg.make_rotation(jnp.asarray(mu)))
    arrs = dict(weight=w, mu_dir=mu, rot=rot, chol=chol,
                inv_chol=np.linalg.inv(chol).astype(np.float32),
                inv_det=(1.0 / (chol[..., 0, 0] * chol[..., 1, 1])
                         ).astype(np.float32),
                valid=rs.rand(n) < 0.9)
    j = jmix.Conditional(**{f: jnp.asarray(v) for f, v in arrs.items()})
    t = tmix.Conditional(**{f: torch.as_tensor(v) for f, v in arrs.items()})
    return j, t


def _assert_cond(jc, tc, rtol=RTOL, atol=ATOL):
    for f in jc._fields:
        a, b = np.asarray(getattr(jc, f)), to_np(getattr(tc, f))
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol,
                                       atol=atol * max(1.0, np.abs(a).max()),
                                       err_msg=f)


def _check_fit():
    rs = np.random.RandomState(0)
    d = rs.randn(3000, 3)
    d[:, 2] = np.abs(d[:, 2]) + 0.3
    d = _unit(d)
    w = rs.rand(3000).astype(np.float32)
    got = tlb.fit_directional_mixture(
        torch.as_tensor(d), torch.as_tensor(w), 4, iters=30,
        init_idx=np.asarray(jax.random.choice(jax.random.PRNGKey(0), 3000,
                                              (4,), replace=False)))
    want = jlb.fit_directional_mixture(d, w, 4, iters=30, seed=0)
    for a, b in zip(want, got):
        np.testing.assert_allclose(to_np(b), a, rtol=FIT_RTOL, atol=1e-5)


@jax.jit
def _ref_prune_product(a, b):
    """The reference's pruned conditionals and products, k = 2 and 4, in
    one compiled call."""
    return [(jmix.prune_conditional(b, k),
             jmix.product(a, jmix.prune_conditional(b, k))) for k in (2, 4)]


def _check_prune_and_product():
    ja, ta = _conditionals(64, 16, 1, spread=0.6)
    jb, tb = _conditionals(64, 4, 2, spread=0.4)
    for (jpruned, jp), top_k in zip(_ref_prune_product(ja, jb), (2, 4)):
        _check_one_product(ta, tb, jpruned, jp, top_k)


def _check_one_product(ta, tb, jpruned, jp, top_k):
    _assert_cond(jpruned, tmix.prune_conditional(tb, top_k))
    tp = tmix.product(ta, tmix.prune_conditional(tb, top_k))
    assert tp.weight.shape == (64, 16 * top_k)
    _assert_cond(jp, tp)


def _check_marginal_and_joint():
    rs = np.random.RandomState(4)
    mu_a = rs.rand(32, 16, 3).astype(np.float32)
    a = rs.randn(32, 16, 3, 3).astype(np.float32) * 0.2 + np.eye(3) * 2.0
    det = (1.0 / np.abs(np.linalg.det(a))).astype(np.float32)
    pos = rs.rand(32, 3).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tmix.marginal_pdf(*(torch.as_tensor(x) for x in
                                  (mu_a, a, det, pos)))),
        np.asarray(jmix.marginal_pdf(mu_a, a, det, pos)), rtol=RTOL)
    mean = np.concatenate([mu_a, _unit(rs.randn(32, 16, 3))], -1)
    rot = np.asarray(jtg.make_rotation(jnp.asarray(mean[..., 3:])))
    d = _unit(rs.randn(32, 3))
    got = tmix.joint_tangent(*(torch.as_tensor(x) for x in (mean, rot, pos,
                                                            d)))
    for g, w in zip(got, jmix.joint_tangent(mean, rot, pos, d)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=RTOL,
                                   atol=1e-6)


def _table(seed=0, b=5, kb=4):
    """A learned table with every mode, as numpy (no fit: the rotation is
    what is tested)."""
    rs = np.random.RandomState(seed)
    nb = jlb.N_THETA_BINS
    w = rs.rand(b, nb, kb)
    a = rs.randn(b, nb, kb, 2, 2) * 0.3
    return {
        "has": np.array([True, True, True, False, True]),
        "mode": np.array([0, 1, 2, 0, 2], np.int32),
        "weight": (w / w.sum(-1, keepdims=True)).astype(np.float32),
        "mu_local": _unit(rs.randn(b, nb, kb, 3) * [0.5, 0.5, 1.0]
                          + [0, 0, 1.0]),
        "cov": (a @ np.swapaxes(a, -1, -2) + 0.05 * np.eye(2)).astype(
            np.float32),
    }


def _check_to_world():
    table = _table()
    rs = np.random.RandomState(5)
    n = 200
    nrm = _unit(rs.randn(n, 3))
    s_ax = _unit(np.cross(nrm, _unit(rs.randn(n, 3))))
    t_ax = np.cross(nrm, s_ax).astype(np.float32)
    wi = _unit(rs.randn(n, 3) * [1, 1, 0.5] + [0, 0, 0.6])
    idx = rs.randint(0, 5, n).astype(np.int32)
    jc, jhas = jax.jit(jlb.to_world_conditional)(
        {k: jnp.asarray(v) for k, v in table.items()}, jnp.asarray(idx),
        *(jnp.asarray(x) for x in (s_ax, t_ax, nrm, wi)))
    tc, thas = tlb.to_world_conditional(
        convert.tensors_from_numpy(table, "cpu"), torch.as_tensor(idx),
        *(torch.as_tensor(x) for x in (s_ax, t_ax, nrm, wi)))
    np.testing.assert_array_equal(to_np(thas), np.asarray(jhas))
    _assert_cond(jc, tc)


def _check_files(tmp_path):
    rs = np.random.RandomState(6)
    w = rs.rand(4).astype(np.float32)
    mu = _unit(rs.randn(4, 3))
    cov = (np.eye(2) * rs.rand(4, 1, 1) + 0.1).astype(np.float32)
    tio.save_bsdf_mixture(str(tmp_path / "port.sdmm"), torch.as_tensor(w),
                          torch.as_tensor(mu), torch.as_tensor(cov))
    jio.save_bsdf_mixture(str(tmp_path / "ref.sdmm"), w, mu, cov)
    for got in (jio.load_bsdf_mixture(str(tmp_path / "port.sdmm")),
                tio.load_bsdf_mixture(str(tmp_path / "ref.sdmm"),
                                      device="cpu")):
        for g, want in zip(got, (w, mu, cov)):
            np.testing.assert_array_equal(to_np(g), want)


def _four_type_box(w=16, h=16):
    ts, cfg = make_box(tscene, tshapes, w, h, extra_bsdfs=True).build(
        device="cpu")
    cfg.max_depth = cfg.rr_depth = 4
    return ts, cfg


def _check_table():
    """Diffuse rows carry the cosine lobe (mode 0), the rough conductor
    eight theta-binned lobes (mode 2); the smooth conductor and dielectric
    have none."""
    ts, _ = _four_type_box()
    table = tlb.build_learned_table(ts, device="cpu")
    types = ts.bsdf_type.numpy()
    has = to_np(table["has"])
    mode = to_np(table["mode"])
    for i, t in enumerate(types):
        assert has[i] == (t in (tscene.BSDF_DIFFUSE,
                                tscene.BSDF_ROUGHCONDUCTOR)), (i, t)
        if t == tscene.BSDF_ROUGHCONDUCTOR:
            assert mode[i] == 2
        elif has[i]:
            assert mode[i] == 0
    w = to_np(table["weight"])[has]
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-4)
    # The cosine lobe's components lie in the upper hemisphere.
    i = int(np.nonzero(types == tscene.BSDF_DIFFUSE)[0][0])
    assert (to_np(table["mu_local"])[i, 0, :, 2] > 0.0).all()


def test_product_training_matches_gt_in_expectation(monkeypatch):
    """SDMMTrainer(sample_product=True) on the four-type box: the mean of
    its iterations' films agrees with the NEE render at 64 spp within 4
    standard errors; product lanes were drawn, guided_sample never ran and
    the frozen tail stayed on the eager pool."""
    def no_kernel(*a, **k):
        raise AssertionError("guided_sample ran with a learned table")

    pools = []
    real_pool = tguided.render_pool_guided

    def pool(*a, **k):
        pools.append(real_pool(*a, **k))
        return pools[-1]

    monkeypatch.setattr(tgs, "guided_sample", no_kernel)
    monkeypatch.setattr(ttrainer, "render_pool_guided", pool)
    ts, cfg = _four_type_box()
    tr = ttrainer.SDMMTrainer(ts, cfg, ttrainer.TrainerConfig(
        max_leaves=64, split_threshold=500, samples_per_iteration=4,
        rays_per_wave=1 << 10, train_fraction=0.75, sample_product=True,
        tail_chunk_spp=8, em=tem.EMConfig(batch_size=256), seed=9),
        device="cpu")
    assert tr.learned is not None and tr.learned_seconds > 0.0
    assert not tguided.guided_fused_supported(tr.scene, cfg,
                                              tr.guide_state())
    _, iters = tr.run(total_spp=24)
    assert len(pools) == len(iters) == 6  # 5 training iterations + 1 tail
    assert tr.stats[4]["optimized_nodes_count"] > 0
    assert int(pools[-1]["n_product"]) > 0
    got = film_mean_se(*(np.sum([it[k] for it in iters], 0)
                         for k in ("image", "sqr", "weight")))
    ref = render_wavefront(ts, cfg, spp=64, seed=2, device="cpu")
    want = film_mean_se(ref["raw"], ref["sqr"], ref["weight"])
    assert within_se(got, want), (got, want)


def test_fit_and_table():
    """The fit from the reference's initial components; the port's table
    on the four-type box."""
    _check_fit()
    _check_table()


def test_products_rotation_and_files_match_reference(tmp_path):
    """Pruning and products (top 2 and top 4), the spatial marginal and the
    joint tangent coordinates, the rotation of a table into the world
    frame, and .sdmm files both ways."""
    _check_prune_and_product()
    _check_marginal_and_joint()
    _check_to_world()
    _check_files(tmp_path)
