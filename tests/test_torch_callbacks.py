"""Callbacks of the port: the chunked loops (``callback_chunk``) of CPD,
FilterReg, GMMTree and BCPD, CPD's callbacks loop, and callbacks.py.

Each family's chunk runs the same step as its K = 1 loop, so the port's
callbacks see the same transforms, bit for bit, at every K, stop at the
same iteration, and the host reads the device once per chunk
(``chunked.FETCHES``). Against the JAX package: the five cases of
tests/test_callback_chunk.py with its tolerances (CPD 1e-5; FilterReg,
GMMTree and BCPD 5e-4, whose reference chunk runs another layout than its
K = 1 loop); both packages take the same horse subsets on the CPU.
"""

import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu import bcpd as jb  # noqa: E402
from probreg_tpu import cpd as jcpd  # noqa: E402
from probreg_tpu import filterreg as jf  # noqa: E402
from probreg_tpu import gmmtree as jgt  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import bcpd as pb  # noqa: E402
from probreg_tpu_torch import callbacks as pcb  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch import filterreg as pf  # noqa: E402
from probreg_tpu_torch import gmmtree as pgt  # noqa: E402
from probreg_tpu_torch.utils import chunked  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: many small dense steps, which spin on
    oversubscribed cores under the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Recorder:
    """Records each callback's rigid (rot, t) as float64 numpy."""

    def __init__(self, extract):
        self._extract = extract
        self.rots, self.ts = [], []

    def __call__(self, transformation):
        r, t = self._extract(transformation)
        self.rots.append(np.asarray(r, np.float64).copy())
        self.ts.append(np.asarray(t, np.float64).copy())


def _rigid(tr):
    return _host(tr.rot), _host(tr.t)


def _combined(tr):
    return _host(tr.rigid_trans.rot), _host(tr.rigid_trans.t)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _clouds(horse_cloud, stride=3):
    """tests/test_callback_chunk.py's pair."""
    src = np.asarray(horse_cloud, dtype=np.float32)[::stride]
    rot = np.asarray(jso.euler2mat(*np.deg2rad([6.0, -3.0, 8.0])),
                     np.float32)
    return src, src @ rot.T


def _same(a, b, atol=None):
    assert len(a.rots) == len(b.rots), (len(a.rots), len(b.rots))
    for ra, rb, ta, tb in zip(a.rots, b.rots, a.ts, b.ts):
        if atol is None:
            assert np.array_equal(ra, rb) and np.array_equal(ta, tb)
        else:
            np.testing.assert_allclose(ra, rb, atol=atol)
            np.testing.assert_allclose(ta, tb, atol=atol)


FAMILIES = {
    # name: (port call, reference call, extract, stride, maxiter, chunk,
    #        atol against the reference)
    "cpd": (pcpd.registration_cpd, jcpd.registration_cpd, _rigid, 3, 9, 4,
            1e-5),
    "filterreg": (pf.registration_filterreg, jf.registration_filterreg,
                  _rigid, 3, 9, 4, 5e-4),
    "gmmtree": (pgt.registration_gmmtree, jgt.registration_gmmtree, _rigid,
                3, 8, 4, 5e-4),
    "bcpd": (pb.registration_bcpd, jb.registration_bcpd, _combined, 6, 6, 3,
             5e-4),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_callbacks_equal_chunk_one_and_match_reference(
        horse_cloud, monkeypatch, family):
    """tests/test_callback_chunk.py's case for each family: at a fixed
    depth the chunk-K callbacks equal the chunk-1 ones bit for bit, with
    ceil(maxiter / K) host reads, and the reference's chunked sequence
    within its tolerance (GMMTree on the reference's tree: the port draws
    its leaves from another generator)."""
    port, ref, extract, stride, maxiter, k, atol = FAMILIES[family]
    src, tgt = _clouds(horse_cloud, stride)
    if family == "gmmtree":
        nodes = interop.gmmtree_nodes_from_reference(
            *(np.asarray(a) for a in jgt.GMMTree(src)._nodes), **CPU)
        monkeypatch.setattr(pgt.GMMTree, "set_source",
                            lambda self, source: setattr(self, "_nodes",
                                                         nodes))
    recs = {}
    for chunk in (1, k):
        recs[chunk] = Recorder(extract)
        chunked.reset_fetches()
        port(src, tgt, maxiter=maxiter, tol=0.0, callbacks=[recs[chunk]],
             callback_chunk=chunk, **CPU)
        assert chunked.FETCHES == math.ceil(maxiter / chunk)
    assert len(recs[1].rots) == maxiter
    _same(recs[1], recs[k])
    want = Recorder(lambda tr: (tr.rigid_trans.rot, tr.rigid_trans.t)
                    if family == "bcpd" else (tr.rot, tr.t))
    ref(src, tgt, maxiter=maxiter, tol=0.0, callbacks=[want],
        callback_chunk=k)
    _same(recs[k], want, atol)


def test_cpd_chunked_convergence_stop(horse_cloud):
    """tests/test_callback_chunk.py:test_cpd_chunked_convergence_stop: the
    stop test fires at the same iteration at every K, and at the
    reference's."""
    src, tgt = _clouds(horse_cloud)
    recs, res = {}, {}
    for chunk in (1, 4):
        recs[chunk] = Recorder(_rigid)
        res[chunk] = pcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-3,
                                           callbacks=[recs[chunk]],
                                           callback_chunk=chunk, **CPU)
    want = Recorder(_rigid)
    jcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-3, callbacks=[want],
                          callback_chunk=4)
    assert len(recs[1].rots) == len(recs[4].rots) == len(want.rots) < 50
    _same(recs[1], recs[4])
    assert torch.equal(res[1].transformation.rot, res[4].transformation.rot)


@pytest.mark.parametrize("kind", ["affine", "nonrigid"])
def test_cpd_callbacks_loop_other_kinds_match_reference(kind):
    """The callbacks loop serves every kind (reference cpd.py:771-880): the
    fish, 5 iterations, the moved source each iteration."""
    import os

    data = os.path.join(os.path.dirname(__file__), "..", "data")
    src, tgt = (np.loadtxt(os.path.join(data, f"fish_{w}.txt")).astype(
        np.float32) for w in ("source", "target"))
    seen_p, seen_j = [], []
    pcpd.registration_cpd(src, tgt, kind, maxiter=5, tol=0.0,
                          callbacks=[lambda tr: seen_p.append(
                              _host(tr.transform(src)))],
                          callback_chunk=2, **CPU)
    jcpd.registration_cpd(src, tgt, kind, maxiter=5, tol=0.0,
                          callbacks=[lambda tr: seen_j.append(
                              np.asarray(tr.transform(src)))],
                          callback_chunk=2)
    assert len(seen_p) == len(seen_j) == 5
    for a, b in zip(seen_p, seen_j):
        np.testing.assert_allclose(a, b, atol=5e-5)


def test_run_chunked_replays_and_fetches_once_per_chunk():
    """run_chunked alone: the last chunk holds only the iterations left, the
    stop test ends the replay, one fetch per chunk, and float64 and bool
    history rows come back exact."""
    calls = []

    def chunk_fn(state, k):
        calls.append(k)
        rows = [(torch.tensor(state + j, dtype=torch.float64) / 3.0,
                 torch.tensor((state + j) % 4 == 3)) for j in range(k)]
        return state + k, chunked.stack_history(rows)

    seen = []

    def handle(i, host, j):
        assert host[0].dtype == torch.float64 and host[1].dtype == torch.bool
        assert host[0][j].item() == i / 3.0
        seen.append(i)
        return bool(host[1][j]) and i > 5, i

    chunked.reset_fetches()
    assert chunked.run_chunked(chunk_fn, 0, 10, 4, handle) == 7
    assert calls == [4, 4] and seen == list(range(8))
    assert chunked.FETCHES == 2
    assert chunked.run_chunked(chunk_fn, 0, 0, 4, handle) is None
    calls.clear()
    chunked.run_chunked(chunk_fn, 0, 5, 4, lambda i, host, j: (False, i))
    assert calls == [4, 1]


def test_plot2d_callback_under_agg(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import os

    monkeypatch.chdir(tmp_path)
    data = os.path.join(os.path.dirname(__file__), "..", "data")
    src, tgt = (np.loadtxt(os.path.join(data, f"fish_{w}.txt")).astype(
        np.float32) for w in ("source", "target"))
    cb = pcb.Plot2DCallback(src, tgt, save=True)
    pcpd.registration_cpd(src, tgt, maxiter=3, tol=0.0, callbacks=[cb],
                          **CPU)
    assert sorted(os.listdir(tmp_path)) == [f"image_{i:04d}.png"
                                            for i in range(3)]
    np.testing.assert_allclose(cb._result.shape, src.shape)


def test_open3d_callback_needs_open3d_and_asnumpy_takes_tensors(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)
    with pytest.raises(ImportError, match="open3d"):
        pcb.Open3dVisualizerCallback(np.zeros((3, 3)), np.zeros((3, 3)))
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    assert np.array_equal(pcb.asnumpy(x), np.arange(6.0).reshape(2, 3))
    assert np.array_equal(pcb.asnumpy([1, 2]), np.array([1, 2]))
