"""The port's Improved Fast Gauss Transform (ops/ifgt.py) and
GaussTransform(method="ifgt") held to the JAX package's Ifgt within
1e-5 sum|w|, and to the exact transform within the reference's error
envelope (eps sum|w| + 2e-6, tests/test_ifgt.py:49)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from probreg_tpu.ops import ifgt as jif  # noqa: E402
from probreg_tpu_torch import gauss_transform as pgt  # noqa: E402
from probreg_tpu_torch.ops import ifgt as pif  # noqa: E402

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _direct(source, target, weights, h):
    d2 = ((target[:, None].astype(np.float64) - source[None]) ** 2).sum(-1)
    return np.exp(-d2 / (h * h)) @ weights


def test_parameter_selection_is_the_references():
    for dims, p in ((2, 4), (3, 6)):
        np.testing.assert_array_equal(pif.multi_indices(dims, p),
                                      jif.multi_indices(dims, p))
        assert len(pif.multi_indices(dims, p)) == math.comb(p - 1 + dims,
                                                            dims)
    for args in ((3, 0.2, 0.5, 1e-4, 0.1), (2, 0.05, 0.3, 1e-2, 0.2)):
        assert pif.choose_truncation_number(*args) \
            == jif.choose_truncation_number(*args)
    assert pif.choose_parameters(3, 0.3, 1e-4, 1.0, 20) \
        == jif.choose_parameters(3, 0.3, 1e-4, 1.0, 20)


def test_kcenter_matches_the_reference(rng):
    """tests/test_ifgt.py:12's blobs, then a cloud with the reference's
    labels, centres and radii."""
    a = rng.normal(size=(50, 3)) * 0.1
    b = rng.normal(size=(50, 3)) * 0.1 + np.array([5.0, 0, 0])
    data = np.concatenate([a, b]).astype(np.float32)
    res = pif.kcenter_clustering(data, 2, **CPU)
    labels = res.labels.numpy()
    assert len(set(labels[:50])) == 1 and len(set(labels[50:])) == 1
    assert labels[0] != labels[50]
    data = rng.random((600, 3)).astype(np.float32)
    ref = jif.kcenter_clustering(data, 12)
    got = pif.kcenter_clustering(data, 12, **CPU)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-5)
    np.testing.assert_allclose(got.radii.numpy(), np.asarray(ref.radii),
                               atol=1e-5)
    assert abs(got.max_cluster_radius - ref.max_cluster_radius) <= 1e-5


@pytest.mark.parametrize("n, dims, h, eps, offset", [
    (3000, 3, 0.2, 1e-4, 0.0),    # tests/test_ifgt.py:49's envelope
    (900, 3, 0.5, 1e-2, 1e3),     # far from the origin (test_ifgt.py:75)
    (500, 2, 0.05, 1e-2, 0.0),    # 2-D at 0.05 x the range
])
def test_ifgt_against_reference_and_exact(n, dims, h, eps, offset):
    g = np.random.default_rng(12)
    src = (g.uniform(0, 1, (n, dims)) + offset).astype(np.float32)
    tgt = (g.uniform(0, 1, (n // 2, dims)) + offset).astype(np.float32)
    w = g.uniform(0.2, 1.0, n).astype(np.float32)
    ref = jif.Ifgt(src, h, eps)
    got = pif.Ifgt(src, h, eps, **CPU)
    assert got._p == ref._p
    assert got._cluster.centers.shape == tuple(ref._cluster.centers.shape)
    out = got.compute(tgt, w).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref.compute(tgt, w)),
                               atol=1e-5 * w.sum())
    assert np.abs(out - _direct(src, tgt, w, h)).max() <= eps * w.sum() \
        + 2e-6 * w.sum()


def test_gauss_transform_facade_ifgt(rng):
    """GaussTransform(method="ifgt"): 1-D weights, default ones and 2-D
    weights row by row (reference gauss_transform.py:58-64)."""
    src = rng.random((400, 3)).astype(np.float32)
    tgt = rng.random((150, 3)).astype(np.float32)
    w = rng.random((2, 400)).astype(np.float32)
    gt = pgt.GaussTransform(src, 0.3, eps=1e-4, method="ifgt", **CPU)
    exact = pgt.GaussTransform(src, 0.3, **CPU)
    both = gt.compute(tgt, w)
    assert both.shape == (2, 150)
    for row, wr in zip(both.numpy(), w):
        np.testing.assert_allclose(row, gt.compute(tgt, wr).numpy())
        assert np.abs(row - _direct(src, tgt, wr, 0.3)).max() \
            <= (1e-4 + 2e-6) * wr.sum()
    np.testing.assert_allclose(gt.compute(tgt).numpy(),
                               exact.compute(tgt).numpy(),
                               atol=(1e-4 + 2e-6) * 400)
    with pytest.raises(ValueError, match="method"):
        pgt.GaussTransform(src, 0.3, method="fgt", **CPU)
