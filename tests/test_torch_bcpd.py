"""Combined BCPD of the port (probreg_tpu_torch.bcpd, ops.lowrank,
ops.bcpd_cuda) held to the JAX package.

Both packages get the same numpy inputs on the CPU: the kernel maps and
low-rank factors, the E- and M-steps, the plain version of the row-weighted
culled E-step against the reference's ``bcpd_estep_culled`` in interpret
mode and against the dense math, the VI loop ``_run_bcpd`` on its dense,
blocked and culled branches, and ``registration_bcpd`` end to end.

Tolerances, each with its reason:
* kernel maps and closed forms: 1e-6 relative (f32 rounding);
* Nystrom factors: only sign-invariant quantities (U diag(lam) U^T,
  U S U^T, diag Sigma, the Woodbury solution) to 2e-4 of their largest
  entry: eigh and the SVD run in other orders, and the IMQ Gram matrix is
  ill-conditioned;
* E-steps and the transposed M-step on the same inputs: 1e-5 relative;
  the row-major M-step 1e-4 (the dense M x M solve with the
  ill-conditioned IMQ Gram matrix, and the SVD, in other orders); with
  the Nystrom factors of the 91-point fish at rank 30, 1e-3 (diag Sigma
  inherits the factors' own spread, 4e-4 measured);
* the culled E-step: 1e-4 of the largest entry (the reference's own
  criterion, tests/test_culled_estep.py), e1 1e-4 relative; dmin a lower
  bound everywhere, exact to 1e-3 where the nearest neighbour lies in an
  active tile;
* the VI loop against the reference's culled loop: rmse 1e-5, rot and v
  1e-4 (the reference's own tolerances, tests/test_culled_estep.py);
* registration at a fixed small depth (tol = 0): transforms 1e-4; past
  convergence the VI is chaotic in f32, so deeper runs are not compared.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from probreg_tpu import bcpd as jb  # noqa: E402
from probreg_tpu.ops import estep_pallas as jep  # noqa: E402
from probreg_tpu.ops import lowrank as jlr  # noqa: E402
from probreg_tpu.ops.spatial import morton_order_np  # noqa: E402
from probreg_tpu.utils import math_utils as jmu  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import bcpd as pb  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch.ops import bcpd_cuda as pbc  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops import lowrank as plr  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import math_utils as pmu  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _fish():
    load = lambda w: np.loadtxt(os.path.join(  # noqa: E731
        _ROOT, "data", f"fish_{w}.txt")).astype(np.float32)
    return load("source"), load("target")


def _horse(n, seed):
    from probreg_tpu_torch.utils import io

    pts = io.read_point_cloud(os.path.join(_ROOT, "data", "horse.ply"))
    rng = np.random.default_rng(seed)
    return pts[rng.choice(len(pts), n, replace=False)].astype(np.float32)


def test_kernel_maps_and_closed_forms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 3)).astype(np.float32) + 3.0
    y = rng.normal(size=(90, 3)).astype(np.float32) + 3.0
    assert _rel(pmu.inverse_multiquadric_kernel(_t(x), _t(y)),
                jmu.inverse_multiquadric_kernel(jnp.asarray(x),
                                                jnp.asarray(y))) < 1e-6
    assert abs(pmu.squared_kernel_sum_np(x, y)
               / jmu.squared_kernel_sum_np(x, y) - 1.0) < 1e-12
    np.testing.assert_allclose(
        float(pmu.compute_rmse(_t(x), _t(y))),
        float(jmu.compute_rmse(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)


def test_lowrank_matches_reference_on_sign_invariant_quantities():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    u_j, lam_j = (np.asarray(a, np.float64)
                  for a in jlr.lowrank_imq(jnp.asarray(pts), 1.0, 20))
    u_p, lam_p = (a.double().numpy() for a in plr.lowrank_imq(_t(pts), 1.0,
                                                              20))
    assert u_p.shape == (300, 20)
    assert _rel(lam_p, lam_j) < 2e-4
    assert _rel((u_p * lam_p) @ u_p.T, (u_j * lam_j) @ u_j.T) < 2e-4
    nu = rng.uniform(0.1, 1.0, 300).astype(np.float32)
    rhs = rng.normal(size=(300, 3)).astype(np.float32)
    got = plr.regularized_sigma(*plr.lowrank_imq(_t(pts), 1.0, 20), _t(nu),
                                0.7, 2.0)
    want = jax.jit(jlr.regularized_sigma)(*jlr.lowrank_imq(jnp.asarray(pts), 1.0, 20),
                                 jnp.asarray(nu), 0.7, 2.0)
    assert _rel(got[1], want[1]) < 2e-4
    core_p = u_p @ got[0].double().numpy() @ u_p.T
    core_j = u_j @ np.asarray(want[0], np.float64) @ u_j.T
    assert _rel(core_p, core_j) < 2e-4
    sol_p = plr.woodbury_solve(*plr.lowrank_imq(_t(pts), 1.0, 20), _t(nu),
                               0.5, _t(rhs))
    sol_j = jax.jit(jlr.woodbury_solve)(*jlr.lowrank_imq(jnp.asarray(pts), 1.0, 20),
                               jnp.asarray(nu), 0.5, jnp.asarray(rhs))
    assert _rel(sol_p, sol_j) < 2e-4
    gx_p = u_p @ plr.woodbury_coeffs(*plr.lowrank_imq(_t(pts), 1.0, 20),
                                     _t(nu), 0.5, _t(rhs)).double().numpy()
    gx_j = u_j @ np.asarray(jax.jit(jlr.woodbury_coeffs)(
        *jlr.lowrank_imq(jnp.asarray(pts), 1.0, 20), jnp.asarray(nu), 0.5,
        jnp.asarray(rhs)), np.float64)
    assert _rel(gx_p, gx_j) < 2e-4
    # RBF factors too, at an exactly representable spectrum check.
    u_r, lam_r = plr.lowrank_rbf(_t(pts), 0.5, 20)
    u_rj, lam_rj = jlr.lowrank_rbf(jnp.asarray(pts), 0.5, 20)
    assert _rel((u_r * lam_r) @ u_r.T,
                (np.asarray(u_rj) * np.asarray(lam_rj)) @ np.asarray(u_rj).T
                ) < 2e-4


@pytest.fixture(scope="module")
def step_inputs():
    """One VI state on the fish pair: the E-step moments, the dense Gram
    matrix and its rank-30 factors."""
    src, tgt = _fish()
    rng = np.random.default_rng(2)
    m = src.shape[0]
    rot = jso.euler2mat(0.0, 0.0, 0.1).__array__().astype(np.float32)[:2, :2]
    return dict(
        src=src, tgt=tgt, t_src=(src @ rot.T + 0.05).astype(np.float32),
        rot=rot, t=np.array([0.05, 0.05], np.float32), scale=1.1,
        alpha=rng.uniform(0.5, 1.5, m).astype(np.float32) / m,
        sdiag=rng.uniform(0.0, 0.1, m).astype(np.float32), sigma2=0.3)


def test_estep_and_combined_mstep_match_reference(step_inputs):
    d = step_inputs
    args_j = (jnp.asarray(d["t_src"]), jnp.asarray(d["tgt"]),
              jnp.asarray(d["scale"]), jnp.asarray(d["alpha"]),
              jnp.asarray(d["sdiag"]), jnp.asarray(d["sigma2"]), 0.1)
    est_j = jax.jit(jb.bcpd_estep, static_argnums=6)(*args_j)
    est_p = pb.bcpd_estep(_t(d["t_src"]), _t(d["tgt"]),
                          torch.tensor(d["scale"]), _t(d["alpha"]),
                          _t(d["sdiag"]), torch.tensor(d["sigma2"]), 0.1)
    for a, b in zip(est_p, est_j):
        assert _rel(a, b) < 1e-5
    src = d["src"]
    gram_j = jmu.inverse_multiquadric_kernel(jnp.asarray(src),
                                             jnp.asarray(src))
    gram_p = pmu.inverse_multiquadric_kernel(_t(src), _t(src))
    low_j = tuple(jlr.lowrank_imq(jnp.asarray(src), 1.0, 30))
    low_p = tuple(plr.lowrank_imq(_t(src), 1.0, 30))
    mstep_j = jax.jit(jb.combined_mstep)
    for gj, gp in ((gram_j, gram_p), (low_j, low_p)):
        out_j = mstep_j(
            jnp.asarray(src), jnp.asarray(d["tgt"]), jnp.asarray(d["rot"]),
            jnp.asarray(d["t"]), jnp.asarray(d["scale"]), est_j, gj,
            jnp.asarray(2.0), jnp.asarray(1e20), jnp.asarray(d["sigma2"]))
        out_p = pb.combined_mstep(
            _t(src), _t(d["tgt"]), _t(d["rot"]), _t(d["t"]),
            torch.tensor(d["scale"]), est_p, gp, torch.tensor(2.0),
            torch.tensor(1e20), torch.tensor(d["sigma2"]))
        tr_j, tr_p = out_j[0], out_p[0]
        tol = 1e-4 if gj is gram_j else 1e-3
        for name in ("rot", "t", "scale"):
            assert _rel(getattr(tr_p.rigid_trans, name),
                        getattr(tr_j.rigid_trans, name)) < tol, name
        for a, b in zip(out_p[1:], out_j[1:]):  # u_hat, sigma, alpha, s2
            assert _rel(a, b) < tol


@pytest.mark.parametrize("low_rank", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_vi_mstep_t_matches_reference(step_inputs, low_rank, residual):
    d = step_inputs
    src = d["src"]
    ys_t = src.T.copy()
    est = jax.jit(jb.bcpd_estep, static_argnums=6)(jnp.asarray(d["t_src"]), jnp.asarray(d["tgt"]),
                        jnp.asarray(d["scale"]), jnp.asarray(d["alpha"]),
                        jnp.asarray(d["sdiag"]), jnp.asarray(d["sigma2"]),
                        0.0)
    px_t = np.asarray(est.px).T.copy()
    nu = np.asarray(est.nu)
    s1 = float((np.asarray(est.nu_d) * (d["tgt"] ** 2).sum(1)).sum())
    rng = np.random.default_rng(3)
    v_prev_t = (0.01 * rng.normal(size=ys_t.shape)).astype(np.float32)
    # e1 = sum p d2 of this posterior, from its moments in float64.
    ts = d["t_src"].astype(np.float64)
    e1 = s1 - 2.0 * float((px_t.T * ts).sum()) \
        + float((nu * (ts * ts).sum(1)).sum())
    extra = dict(e1=e1, t_src_t=d["t_src"].T.copy(),
                 v_prev_t=v_prev_t) if residual else {}
    if low_rank:
        gj = tuple(jlr.lowrank_imq(jnp.asarray(src), 1.0, 30))
        gp = tuple(plr.lowrank_imq(_t(src), 1.0, 30))
    else:
        gj = jmu.inverse_multiquadric_kernel(jnp.asarray(src),
                                             jnp.asarray(src))
        gp = pmu.inverse_multiquadric_kernel(_t(src), _t(src))
    out_j = jax.jit(jb._vi_mstep_t)(
        jnp.asarray(ys_t), jnp.asarray(d["rot"]), jnp.asarray(d["t"]),
        jnp.asarray(d["scale"]), jnp.asarray(d["sigma2"]), gj,
        jnp.asarray(2.0), jnp.asarray(1e20), jnp.asarray(px_t),
        jnp.asarray(nu), jnp.asarray(s1),
        **{k: (v if k == "e1" else jnp.asarray(v)) for k, v in extra.items()})
    out_p = pb._vi_mstep_t(
        _t(ys_t), _t(d["rot"]), _t(d["t"]), torch.tensor(d["scale"]),
        torch.tensor(d["sigma2"]), gp, torch.tensor(2.0), torch.tensor(1e20),
        _t(px_t), _t(nu), torch.tensor(s1),
        **{k: (v if k == "e1" else _t(v)) for k, v in extra.items()})
    tol = 1e-3 if low_rank else 1e-5  # the Nystrom factors' own spread
    for a, b in zip(out_p, out_j):
        assert _rel(a, b) < tol


def _clustered(seed=0, m=700, n=900):
    """The 700 x 900 clustered clouds of tests/test_culled_estep.py:213-259,
    Morton-sorted, and the E-step's row weights."""
    rng = np.random.default_rng(seed)
    centers = np.array([[i * 4.0, j * 4.0, 0.0]
                        for i in range(2) for j in range(2)], np.float32)
    src = (centers[rng.integers(0, 4, m)]
           + rng.normal(0, 0.3, (m, 3))).astype(np.float32)
    tgt = (centers[rng.integers(0, 4, n)]
           + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    s = src[morton_order_np(src)]
    t = tgt[morton_order_np(tgt)]
    alpha = rng.uniform(0.5, 1.5, m).astype(np.float32) / m
    sdiag = rng.uniform(0.0, 0.1, m).astype(np.float32)
    return s, t, alpha, sdiag


@pytest.mark.parametrize("sigma2", [2.0, 0.05])
def test_culled_estep_plain_version_matches_reference(sigma2):
    """The plain version of the row-weighted stash kernels on a multi-tile
    grid (128-tiles): against the dense math at both sigma2 (a share of the
    tiles culled at 0.05) and, at sigma2 = 2.0, against the reference's
    bcpd_estep_culled in interpret mode."""
    s, t, alpha, sdiag = _clustered()
    dim, w, n = 3, 0.1, t.shape[0]
    rowlog = (np.log((1 - w) * alpha) - 1.0 / (2 * sigma2) * sdiag * dim
              - dim * 0.5 * np.log(2 * np.pi * sigma2)).astype(np.float32)
    d2 = ((s[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    pmat = np.exp(rowlog[:, None] - d2 / (2 * sigma2))
    den = w / n + pmat.sum(0)
    den = np.where(den == 0, np.finfo(np.float32).eps, den)
    pm = pmat / den
    x2 = (t * t).sum(1)
    v_t = np.concatenate([t.T, np.ones((1, n)), x2[None]], 0).astype(
        np.float32)
    nud, mom, dmin, e1 = pbc.bcpd_estep_culled(
        _t(s), _t(t), _t(rowlog), _t(v_t), w / n, sigma2, tile_m=128,
        tile_n=128)
    mask, _ = pbc.cull_mask(_t(s), _t(t), _t(rowlog),
                            torch.tensor(0.5 / sigma2), 128, 128)
    if sigma2 < 1.0:
        assert 0.0 < float(mask.float().mean()) < 1.0  # tiles were culled
    assert _rel(nud, pm.sum(0)) < 1e-4
    assert _rel(mom, v_t @ pm.T) < 1e-4
    e1_ref = float((pm * d2).sum())
    assert abs(float(e1) - e1_ref) <= 1e-4 * abs(e1_ref)
    dmin, dmin_ref = dmin.numpy(), d2.min(1)
    assert np.all(dmin <= dmin_ref + 1e-3)
    assert np.mean(np.abs(dmin - dmin_ref) < 1e-3) > 0.99
    if sigma2 == 2.0:
        got = (nud, mom, dmin, e1)
        want = jep.bcpd_estep_culled(s, t, rowlog, v_t, w / n, sigma2,
                                     tile_m=128, tile_n=128, interpret=True)
        for a, b in zip(got, want):
            assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("m", [524_288, 524_289, 750_000])
def test_bcpd_tile_n_is_the_references(m):
    """BCPD's tile_n is capped by config.bcpd_stash_max_bytes (2 GiB), as
    in the reference, whatever the device: past M = 524,288 the (M_padded,
    1024) f32 stash would exceed it and tile_n halves to 512."""
    want = jep._capped_stash_tile_n(m, 1024, 1024)
    assert pbc.bcpd_tile_n(m, 4096) == want
    assert pbc.bcpd_tile_n(m, 4096, tile_n=1024) == (1024 if m <= 524_288
                                                     else 512)


def test_bcpd_tile_n_raises_beyond_the_floor(monkeypatch):
    """Beyond the 256 floor the tile choice raises and names the knob, as
    the reference's does."""
    monkeypatch.setattr(pcfg.config, "bcpd_stash_max_bytes", 1 << 20)
    assert pbc.bcpd_tile_n(1024, 4096) == 256
    with pytest.raises(ValueError, match="bcpd_stash_max_bytes"):
        pbc.bcpd_tile_n(2048, 4096)
    with pytest.raises(ValueError, match="bcpd_stash_max_bytes"):
        jep._capped_stash_tile_n(2048, 1024, 1024, budget=1 << 20)


def test_culled_estep_tile_lists_cover_the_cull_mask():
    """The lists that K8's two passes walk (estep_cuda._compact of
    cull_mask's mask and of its transpose) on the clustered clouds at
    sigma2 = 0.05, where a share of the tile pairs is culled: each stripe's
    list holds exactly its active source tiles and each source tile's
    exactly its active stripes, ascending, so both passes visit every
    active pair once."""
    s, t, alpha, sdiag = _clustered()
    sigma2 = 0.05
    rowlog = (np.log(0.9 * alpha) - 1.5 * np.log(2 * np.pi * sigma2)
              ).astype(np.float32)
    mask, _ = pbc.cull_mask(_t(s), _t(t), _t(rowlog),
                            torch.tensor(0.5 / sigma2), 128, 128)
    col_idx, col_cnt = pec._compact(mask)
    row_idx, row_cnt = pec._compact(mask.T)
    active = int(mask.sum())
    assert 0 < active < mask.numel()
    assert int(col_cnt.sum()) == int(row_cnt.sum()) == active
    for i in range(mask.shape[0]):
        want = torch.nonzero(mask[i]).flatten().tolist()
        assert row_idx[i, :int(row_cnt[i])].tolist() == want
    for j in range(mask.shape[1]):
        want = torch.nonzero(mask[:, j]).flatten().tolist()
        assert col_idx[j, :int(col_cnt[j])].tolist() == want


def test_culled_estep_all_rowlog_underflow_keeps_dmin_honest():
    """max rowlog < -104: the clamp keeps overlapping tiles active, so dmin
    stays the true nearest-neighbour distance (tests/test_culled_estep.py
    :487-511)."""
    g = np.arange(4, dtype=np.float32) * 2.0
    src = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
    src = src[morton_order_np(src)]
    tgt = (src + 1.0).astype(np.float32)
    m = src.shape[0]
    rowlog = np.full((m,), -120.0, np.float32)
    v_t = np.concatenate([tgt.T, np.ones((1, m), np.float32),
                          (tgt ** 2).sum(1)[None]], 0)
    _, _, dmin, _ = pbc.bcpd_estep_culled(
        _t(src), _t(tgt), _t(rowlog), _t(v_t), 1e-3 / m, 0.05, tile_m=64,
        tile_n=64)
    true_nn = ((src[:, None] - tgt[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(dmin.numpy(), true_nn, atol=1e-4)


@pytest.fixture(scope="module")
def vi_case():
    """The 800-point case of tests/test_culled_estep.py:262-297, with the
    reference's culled VI loop (interpret mode) run once."""
    rng = np.random.default_rng(2)
    m = 800
    src = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    rot = np.asarray(jso.euler2mat(*np.deg2rad([8.0, -4.0, 10.0])),
                     np.float32)
    tgt = (src @ rot.T).astype(np.float32)
    cen = np.concatenate([src, tgt]).mean(0)
    sc = float(np.sqrt(jmu.squared_kernel_sum(
        jnp.asarray(src - cen), jnp.asarray(tgt - cen))))
    s0, t0 = (src - cen) / sc, (tgt - cen) / sc
    s = s0[morton_order_np(s0)].astype(np.float32)
    t = t0[morton_order_np(t0)].astype(np.float32)
    sigma2_0 = float(jmu.squared_kernel_sum(jnp.asarray(s), jnp.asarray(t)))
    gmat = tuple(jlr.lowrank_imq(jnp.asarray(s), 1.0, 50))
    tr, _, _, _, rmse, _ = jb._run_bcpd(
        jnp.asarray(s), jnp.asarray(t), gmat, jnp.asarray(10.0, jnp.float32),
        jnp.asarray(1e20, jnp.float32), jnp.asarray(sigma2_0, jnp.float32),
        w=0.0, maxiter=40, tol=1e-7, block=4096, use_culled=True,
        culled_interpret=True)
    return s, t, sigma2_0, tr, float(rmse)


@pytest.mark.parametrize("branch", ["dense", "blocked", "culled"])
def test_run_bcpd_matches_reference_culled_loop(vi_case, branch):
    s, t, sigma2_0, tr_j, rmse_j = vi_case
    gmat = tuple(plr.lowrank_imq(_t(s), 1.0, 50))
    kw = dict(w=0.0, maxiter=40, tol=1e-7,
              block=300 if branch == "blocked" else 4096,
              use_culled=branch == "culled")
    tr, _, _, _, rmse, _ = pb._run_bcpd(
        _t(s), _t(t), gmat, torch.tensor(10.0), torch.tensor(1e20),
        torch.tensor(sigma2_0), **kw)
    np.testing.assert_allclose(rmse, rmse_j, atol=1e-5)
    np.testing.assert_allclose(tr.rigid_trans.rot.numpy(),
                               np.asarray(tr_j.rigid_trans.rot), atol=1e-4)
    np.testing.assert_allclose(tr.v.numpy(), np.asarray(tr_j.v), atol=1e-4)


def _reg_close(got, want, src):
    rt_g, rt_w = got.rigid_trans, want.rigid_trans
    np.testing.assert_allclose(rt_g.rot.numpy(), np.asarray(rt_w.rot),
                               atol=1e-4)
    np.testing.assert_allclose(rt_g.t.numpy(), np.asarray(rt_w.t), atol=1e-4)
    np.testing.assert_allclose(float(rt_g.scale), float(rt_w.scale),
                               atol=1e-4)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-4)
    np.testing.assert_allclose(got.transform(src).numpy(),
                               np.asarray(want.transform(src)), atol=1e-4)


@pytest.mark.parametrize("normalize", [True, False])
def test_registration_bcpd_fish_matches_reference(normalize):
    """The 2-D fish with the dense Gram matrix, at a fixed depth."""
    src, tgt = _fish()
    kw = dict(maxiter=8, tol=0.0, normalize=normalize)
    got = pb.registration_bcpd(src, tgt, device="cpu", **kw)
    want = jb.registration_bcpd(src, tgt, **kw)
    _reg_close(got, want, src)


def test_registration_bcpd_low_rank_warm_start_and_last_state():
    """A horse subset with rank= factors, warm-started, with the final
    iterate returned; then the same carried back in as a warm start."""
    src = _horse(500, 6)
    rot = np.asarray(jso.euler2mat(*np.deg2rad([5.0, -3.0, 8.0])),
                     np.float32)
    tgt = (_horse(450, 7) @ rot.T + 0.01).astype(np.float32)
    kw = dict(w=0.0, maxiter=6, tol=0.0, callbacks=[], normalize=True,
              callback_chunk=1, rank=40, lmd=10.0, return_last=True,
              tf_init_params={"rot": np.eye(3), "t": np.full(3, 0.005),
                              "scale": 1.0}, sigma2_init=0.02)
    got, s2_p, last_p, info_p = pb._registration_bcpd_impl(
        src, tgt, device="cpu", **kw)
    want, s2_j, last_j, info_j = jb._registration_bcpd_impl(src, tgt, **kw)
    _reg_close(got, want, src)
    np.testing.assert_allclose(s2_p, s2_j, rtol=1e-4)
    np.testing.assert_allclose(info_p["best"], info_j["best"], atol=1e-5)
    np.testing.assert_allclose(info_p["last"], info_j["last"], atol=1e-5)
    np.testing.assert_allclose(last_p["v_init"], last_j["v_init"], atol=1e-4)
    np.testing.assert_allclose(last_p["sigma2_init"], last_j["sigma2_init"],
                               rtol=1e-4)
    np.testing.assert_allclose(last_p["_alpha_init"], last_j["_alpha_init"],
                               rtol=1e-4)
    # Continue both from their final iterates, with the carried VI state.
    kw2 = dict(kw, maxiter=3, **last_j)
    got2 = pb._registration_bcpd_impl(src, tgt, device="cpu", **kw2)[0]
    want2 = jb._registration_bcpd_impl(src, tgt, **kw2)[0]
    _reg_close(got2, want2, src)


def test_callbacks_loop_matches_reference():
    src, tgt = _fish()
    seen_p, seen_j = [], []
    got = pb.registration_bcpd(src, tgt, maxiter=3, tol=0.0, device="cpu",
                               callbacks=[seen_p.append])
    want = jb.registration_bcpd(src, tgt, maxiter=3, tol=0.0,
                                callbacks=[seen_j.append])
    assert len(seen_p) == len(seen_j) == 3
    for a, b in zip(seen_p, seen_j):
        np.testing.assert_allclose(a.v.numpy(), np.asarray(b.v), atol=1e-4)
    _reg_close(got, want, src)


def test_combined_from_reference_moves_source_as_jax_does():
    src, tgt = _fish()
    res = jb.registration_bcpd(src, tgt, maxiter=5, tol=0.0)
    rt = res.rigid_trans
    ported = interop.combined_from_reference(
        {"rot": np.asarray(rt.rot), "t": np.asarray(rt.t),
         "scale": np.asarray(rt.scale), "v": np.asarray(res.v)},
        device="cpu")
    np.testing.assert_allclose(ported.transform(src).numpy(),
                               np.asarray(res.transform(src)), atol=1e-6)


def test_unported_options_raise_and_branches(monkeypatch):
    src, tgt = _fish()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pb.registration_bcpd(src, tgt, device="cpu", n_starts=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pb.registration_bcpd(src, tgt, device="cpu", callbacks=[print],
                             callback_chunk=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pb.registration_bcpd_batch([src], [tgt])
    # The culled branch needs a CUDA device, the knob, the size and rank=.
    assert pcfg.config.bcpd_culled_max_points == 750_000
    bc = pb.CombinedBCPD(src, rank=20, device="cpu")
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1)
    assert not bc._use_culled(91, 91)

    def refuse(*a, **k):
        raise AssertionError("the culled E-step ran")

    monkeypatch.setattr(pbc, "bcpd_estep_culled", refuse)
    pb.registration_bcpd(src, tgt, maxiter=2, device="cpu", rank=20)
    cfg = interop.config_from_reference(
        {"bcpd_culled_max_points": 123, "bcpd_stash_max_bytes": 1})
    assert cfg.bcpd_culled_max_points == 123
