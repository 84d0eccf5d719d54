"""The port's permutohedral lattice and FilterReg's lattice E-step held to
the JAX package: the lattice structure, its filter, the Permutohedral
facade, the whole-EM lattice loop and the lattice host loop.

Both packages take the same seeded numpy features on the CPU. The lattice
approximates the Gauss transform with a ~0.7x bias, so the port's lattice
is held to the reference's lattice, never to the dense moments.
Tolerances: ``size``, offsets and blur neighbours exact (the reference's
n1 / n2 over their first ``size`` columns); barycentric weights 2e-6 at
features of unit scale (the elevation product rounds differently in the
two packages' matrix products); filter outputs 2e-6 of their largest
entry; the EM loops at a fixed depth (tol 0), rotations and translations
1e-5, sigma2 and q 1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import filterreg as jfr  # noqa: E402
from probreg_tpu import gaussian_filtering as jgf  # noqa: E402
from probreg_tpu.ops import permutohedral as jph  # noqa: E402
from probreg_tpu.utils.datagen import blobby_surface  # noqa: E402
from probreg_tpu_torch import filterreg as pfr  # noqa: E402
from probreg_tpu_torch import gaussian_filtering as pgf  # noqa: E402
from probreg_tpu_torch.ops import permutohedral as pph  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in the other port test files under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n, d, with_blur", [(120, 3, True),
                                             (120, 3, False)])
def test_lattice_and_filter_match_reference(n, d, with_blur):
    rng = np.random.default_rng(d)
    f = (rng.standard_normal((n, d)) * 3.0).astype(np.float32)
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    ref = jph.build(jnp.asarray(f), with_blur=with_blur)
    lat = pph.build(torch.from_numpy(f), with_blur=with_blur)
    size = int(ref.size)
    assert lat.size == size
    assert np.array_equal(lat.offsets.numpy(), np.asarray(ref.offsets))
    assert np.array_equal(lat.n1.numpy(), np.asarray(ref.n1)[:, :size])
    assert np.array_equal(lat.n2.numpy(), np.asarray(ref.n2)[:, :size])
    np.testing.assert_allclose(lat.barycentric.numpy(),
                               np.asarray(ref.barycentric), atol=2e-6)
    np.testing.assert_allclose(lat.barycentric.sum(1).numpy(), 1.0,
                               atol=1e-5)
    # reverse changes only the blur's axis order
    for start, reverse in ((n // 2, False), (n // 2, True))[:1 + with_blur]:
        want = np.asarray(jph.filter(ref, jnp.asarray(vals), start=start,
                                     reverse=reverse, with_blur=with_blur))
        got = pph.filter(lat, torch.from_numpy(vals), start=start,
                         reverse=reverse, with_blur=with_blur).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=2e-6 * np.abs(want).max())


def test_permutohedral_facade():
    """The facade over the reference's lattice of the same points (the
    structure test's shapes, so its compiled build is shared)."""
    rng = np.random.default_rng(7)
    p = rng.standard_normal((120, 3)).astype(np.float32)
    v = rng.standard_normal(120).astype(np.float32)
    ref = jph.build(jnp.asarray(p), with_blur=True)
    ours = pgf.Permutohedral(p)
    assert ours.get_lattice_size() == int(ref.size)
    out = ours.filter(v, start=60)
    assert out.shape == (120,) and isinstance(out, torch.Tensor)
    want = np.asarray(jph.filter(ref, jnp.asarray(v)[:, None], start=60,
                                 with_blur=True))[:, 0]
    np.testing.assert_allclose(out.numpy(), want,
                               atol=2e-6 * np.abs(want).max())


def _pair():
    src = blobby_surface(60, seed=4).astype(np.float32)
    rot = pso.euler2mat(0.15, -0.1, 0.25).numpy()
    tgt = (src @ rot.T + np.array([0.04, -0.02, 0.03])).astype(np.float32)
    return src, tgt


KW = dict(objective_type="pt2pt", update_sigma2=True, w=0.0, maxiter=6,
          tol=0.0, min_sigma2=1e-4)


def _close(rot, t, sigma2, q, ref):
    np.testing.assert_allclose(rot.numpy(), np.asarray(ref.transformation.rot),
                               atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(ref.transformation.t),
                               atol=1e-5)
    assert float(sigma2) == pytest.approx(float(ref.sigma2), rel=1e-5)
    assert float(q) == pytest.approx(float(ref.q), rel=1e-5)


@pytest.fixture(scope="module")
def lattice_ref():
    """The reference's ``_run_em_rigid_lattice`` (automatic sigma2, sigma2
    re-estimated) at a fixed depth: the one compiled program both loop
    tests are held to."""
    src, tgt = _pair()
    return jfr._run_em_rigid_lattice(
        jnp.asarray(src), jnp.asarray(tgt), None, jnp.eye(3), jnp.zeros(3),
        np.float32(0.0), sigma2_decay=1.0, auto_sigma2=True, **KW)


def test_lattice_whole_em_matches_reference(lattice_ref):
    """``_run_em_rigid_lattice`` and the entry point with
    ``estep_method='lattice'``, which takes it."""
    src, tgt = _pair()
    got = pfr._run_em_rigid_lattice(
        torch.from_numpy(src), torch.from_numpy(tgt), None, torch.eye(3),
        torch.zeros(3), 0.0, auto_sigma2=True, **KW)
    _close(got.transformation.rot, got.transformation.t, got.sigma2, got.q,
           lattice_ref)
    entry = pfr.registration_filterreg(src, tgt, estep_method="lattice",
                                       device="cpu", **KW)
    _close(entry.transformation.rot, entry.transformation.t, entry.sigma2,
           entry.q, lattice_ref)


def test_lattice_host_loop_matches_reference(lattice_ref):
    """Callbacks take the host loop over ``expectation_step`` (its lattice
    branch) and ``maximization_step``, chunks of 4, against the
    reference's loop (whose own tests hold its host loop to it)."""
    src, tgt = _pair()
    seen = []
    got = pfr.registration_filterreg(src, tgt, estep_method="lattice",
                                     callbacks=[seen.append],
                                     callback_chunk=4, device="cpu", **KW)
    assert len(seen) == KW["maxiter"]
    _close(got.transformation.rot, got.transformation.t, got.sigma2, got.q,
           lattice_ref)
