"""The port's small modules held to the JAX package: checkpoint leaves
across packages, profiling, cupy_utils, the root alias modules, the
interop and chunked helpers, the lazy ``callbacks`` and the public-symbol
parity of the whole package against probreg_tpu/__init__.py.

The parity sweep reads each module the reference package imports with
``ast`` (its public functions, classes and their public methods, and its
public module-level names) and asserts the same-named port module has
them. Numbers: leaves exact; cupy_utils 1e-5 relative.
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import probreg_tpu  # noqa: E402
import probreg_tpu_torch  # noqa: E402
from probreg_tpu import cupy_utils as jcu  # noqa: E402
from probreg_tpu import filterreg as jfr  # noqa: E402
from probreg_tpu.models import transformation as jtf  # noqa: E402
from probreg_tpu.utils import checkpoint as jck  # noqa: E402
from probreg_tpu.utils import chunked as jch  # noqa: E402
from probreg_tpu_torch import cupy_utils as pcu  # noqa: E402
from probreg_tpu_torch import filterreg as pfr  # noqa: E402
from probreg_tpu_torch.models import transformation as ptf  # noqa: E402
from probreg_tpu_torch.utils import checkpoint as pck  # noqa: E402
from probreg_tpu_torch.utils import chunked as pch  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in the other port test files under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REF_PKG = pathlib.Path(probreg_tpu.__file__).parent


def _package_modules():
    """The submodules probreg_tpu/__init__.py imports, and callbacks."""
    tree = ast.parse((REF_PKG / "__init__.py").read_text())
    names = [a.name for n in tree.body
             if isinstance(n, ast.ImportFrom) and n.level == 1
             and n.module is None for a in n.names]
    return sorted(names + ["callbacks"])


def _public(path):
    tree = ast.parse(path.read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_")]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)
              and not t.id.startswith("_") and not t.id.isupper()]
    methods = {n.name: [m.name for m in n.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")]
               for n in tree.body if isinstance(n, ast.ClassDef)
               and not n.name.startswith("_")}
    return names, methods


@pytest.mark.parametrize("mod_name", _package_modules())
def test_public_symbol_parity(mod_name):
    path = REF_PKG / f"{mod_name}.py"
    if not path.exists():
        path = REF_PKG / mod_name / "__init__.py"
    names, methods = _public(path)
    ours = getattr(probreg_tpu_torch, mod_name)
    missing = [n for n in names if not hasattr(ours, n)]
    missing += [f"{c}.{m}" for c, ms in methods.items() for m in ms
                if hasattr(ours, c) and not hasattr(getattr(ours, c), m)]
    assert not missing, f"probreg_tpu_torch.{mod_name} lacks {missing}"
    assert "jax" not in getattr(ours, "__file__", "")


def test_config_eps_matches_reference():
    from probreg_tpu import config as jconfig
    from probreg_tpu_torch import config as pconfig

    assert pconfig.eps() == jconfig.eps()
    for jd, pd in ((np.float32, torch.float32), (np.float64, torch.float64),
                   (np.float16, torch.float16)):
        assert pconfig.eps(pd) == pconfig.eps(jd) == jconfig.eps(jd)


def _rigid_result(pkg):
    rot = np.eye(3, dtype=np.float32)[[1, 0, 2]]
    t = np.array([0.1, -0.2, 0.3], np.float32)
    if pkg == "ref":
        return jfr.MstepResult(jtf.RigidTransformation(
            jnp.asarray(rot), jnp.asarray(t)), np.float32(0.25),
            np.float32(3.5))
    return pfr.MstepResult(ptf.RigidTransformation(rot, t, device="cpu"),
                           torch.tensor(0.25), torch.tensor(3.5))


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_checkpoint_leaves_cross_packages(tmp_path, saver):
    """Leaves saved by either package load with both ``load_leaves``;
    each package's ``load_state`` rebuilds its own result from them."""
    path = str(tmp_path / "state.npz")
    (jck if saver == "ref" else pck).save_state(path, _rigid_result(saver))
    ref, port = jck.load_leaves(path), pck.load_leaves(path)
    assert len(ref) == len(port) == 5      # rot, t, scale, sigma2, q
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)
    back = pck.load_state(path, _rigid_result("port"))
    want = _rigid_result("port")
    assert torch.equal(back.transformation.rot, want.transformation.rot)
    assert torch.equal(back.transformation.t, want.transformation.t)
    assert float(back.sigma2) == 0.25 and float(back.q) == 3.5
    assert pck.rigid_tf_init_params(back.transformation).keys() \
        == jck.rigid_tf_init_params(_rigid_result("ref").transformation
                                    ).keys()


def test_checkpoint_deformable_and_dicts(tmp_path):
    w = ptf.DeformableKinematicModel.SkinningWeight([[0, 1], [1, 0]],
                                                    [[0.5, 0.5], [1, 0]])
    dqs = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    state = {"model": ptf.DeformableKinematicModel(dqs, w, device="cpu"),
             "iters": 7, "sigma2": torch.tensor(0.5)}
    path = str(tmp_path / "dq.npz")
    pck.save_state(path, state)
    back = pck.load_state(path, state)
    assert torch.equal(back["model"].dualquats, dqs)
    assert back["model"].weights is w and int(back["iters"]) == 7
    ref = jtf.DeformableKinematicModel(
        jnp.asarray(dqs.numpy()),
        jtf.DeformableKinematicModel.SkinningWeight(w.pair, w.val))
    jck.save_state(path, ref)
    assert np.array_equal(pck.load_leaves(path)[0], dqs.numpy())


def test_profiling_and_cupy_utils(tmp_path):
    timer = profiling.IterationTimer()
    src = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    pfr.registration_filterreg(src, src + 0.01, callbacks=[timer],
                               maxiter=4, tol=0.0, device="cpu")
    assert len(timer.laps) == 4 and timer.total >= 0.0
    assert profiling.time_fn(torch.mm, torch.eye(4), torch.eye(4),
                             n_iter=3) >= 0.0
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(torch.eye(8), torch.eye(8))
    assert prof.key_averages() is not None
    assert any(tmp_path.iterdir())
    x = np.random.default_rng(1).normal(size=(20, 2)).astype(np.float32)
    y = np.random.default_rng(2).normal(size=(15, 2)).astype(np.float32)
    for name, args in (("squard_norm_outer_kernel", (x, y)),
                       ("squared_kernel_sum", (x, y)),
                       ("rbf_kernel", (x, y, 0.7))):
        np.testing.assert_allclose(
            getattr(pcu, name)(*args).numpy(),
            np.asarray(getattr(jcu, name)(*args)), rtol=1e-5, atol=1e-6)


def test_aliases_interop_chunked():
    from probreg_tpu_torch import math_utils, se3_op, transformation
    from probreg_tpu_torch.utils import math_utils as umu
    from probreg_tpu_torch.utils import se3_op as uso

    assert transformation.RigidTransformation is ptf.RigidTransformation
    assert se3_op.diff_x_from_twist is uso.diff_x_from_twist
    assert math_utils.Normalizer is umu.Normalizer
    assert probreg_tpu_torch.callbacks.__name__.endswith(".callbacks")
    assert interop.has_open3d() in (True, False)
    pts = torch.zeros(3, 3)
    assert interop.maybe_o3_roundtrip(pts, np.zeros((3, 3))) is pts
    hist = (torch.arange(6.0).reshape(3, 2), np.arange(3))
    for j in range(3):
        ours, ref = pch.slice_tree(hist, j), jch.slice_tree(
            tuple(np.asarray(h) for h in hist), j)
        assert np.array_equal(ours[0].numpy(), ref[0])
        assert ours[1] == ref[1]
    res = pch.slice_tree(pfr.MstepResult(torch.ones(2, 3), torch.ones(2),
                                         torch.zeros(2)), 1)
    assert isinstance(res, pfr.MstepResult) and res.q == 0.0
