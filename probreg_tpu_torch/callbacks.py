"""Per-iteration visualization callbacks (counterpart of
probreg_tpu/callbacks.py).

``Plot2DCallback`` draws with matplotlib. ``Open3dVisualizerCallback``
needs the optional open3d package and raises ``ImportError`` when it is
built without it. Both take the transformation a registration hands its
callbacks, on any device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .models.transformation import Transformation
from .utils import interop


def asnumpy(x) -> np.ndarray:
    """A host numpy array of ``x``: a tensor on any device, or anything
    numpy takes (reference callbacks.py:8-15)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_points(x) -> np.ndarray:
    return asnumpy(interop.as_points(x, device="cpu"))


class Plot2DCallback:
    """Display the 2D registration result of each iteration (reference
    callbacks.py:21-62).

    Args:
        source: Source point cloud data.
        target: Target point cloud data.
        save: Save each iteration's image with a sequential number.
        keep_window: Keep the window open after the final iteration.
    """

    def __init__(self, source, target, save: bool = False,
                 keep_window: bool = True):
        import matplotlib.pyplot as plt

        self._plt = plt
        self._source = _host_points(source)
        self._target = _host_points(target)
        self._result = copy.deepcopy(self._source)
        self._save = save
        self._keep_window = keep_window
        self._cnt = 0
        self._plot(save=False)   # the first draw only; frame k = iteration k

    def _plot(self, save=True):
        plt = self._plt
        plt.cla()
        plt.axis("equal")
        plt.plot(self._source[:, 0], self._source[:, 1], "ro", label="source")
        plt.plot(self._target[:, 0], self._target[:, 1], "g^", label="target")
        plt.plot(self._result[:, 0], self._result[:, 1], "bo", label="result")
        plt.legend()
        if self._save and save:
            plt.savefig("image_%04d.png" % self._cnt)
            self._cnt += 1
        plt.draw()
        plt.pause(0.001)

    def __call__(self, transformation: Transformation) -> None:
        self._result = asnumpy(transformation.transform(self._source))
        self._plot()


class Open3dVisualizerCallback:
    """Open3D 3D visualizer callback (reference callbacks.py:65-113);
    needs the optional open3d package."""

    def __init__(self, source, target, save: bool = False,
                 keep_window: bool = True, fov: float = None):
        try:
            import open3d as o3
        except ImportError as e:
            raise ImportError("Open3dVisualizerCallback requires the "
                              "optional open3d package.") from e
        self._o3 = o3
        self._source = self._to_pcd(source)
        self._target = self._to_pcd(target)
        self._result = copy.deepcopy(self._source)
        self._save = save
        self._keep_window = keep_window
        self._vis = o3.visualization.Visualizer()
        self._vis.create_window()
        self._source.paint_uniform_color([1, 0, 0])
        self._target.paint_uniform_color([0, 1, 0])
        self._result.paint_uniform_color([0, 0, 1])
        self._vis.add_geometry(self._source)
        self._vis.add_geometry(self._target)
        self._vis.add_geometry(self._result)
        if fov is not None:
            self._vis.get_view_control().change_field_of_view(step=fov)
        self._cnt = 0

    def _to_pcd(self, x):
        o3 = self._o3
        if isinstance(x, o3.geometry.PointCloud):
            return x
        pcd = o3.geometry.PointCloud()
        pcd.points = o3.utility.Vector3dVector(
            _host_points(x).astype(np.float64))
        return pcd

    def __del__(self):
        if getattr(self, "_keep_window", False):
            self._vis.run()
        if hasattr(self, "_vis"):
            self._vis.destroy_window()

    def __call__(self, transformation: Transformation) -> None:
        moved = asnumpy(transformation.transform(
            np.asarray(self._source.points)))
        self._result.points = self._o3.utility.Vector3dVector(
            moved.astype(np.float64))
        self._vis.update_geometry(self._result)
        self._vis.poll_events()
        self._vis.update_renderer()
        if self._save:
            self._vis.capture_screen_image("image_%04d.png" % self._cnt)
        self._cnt += 1
