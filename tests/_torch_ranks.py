"""Rank functions for the port's spawned test ranks (no JAX import: each
rank imports this module afresh)."""

from probreg_tpu_torch import gmmtree as pgt
from probreg_tpu_torch.parallel import _spmd
from probreg_tpu_torch.utils import interop


def rank_calls_on_tree(device, nodes, calls):
    """``_spmd.rank_calls`` with every GMMTree built from a source taking
    ``nodes`` (numpy pi, mu, cov: a tree the JAX package built) in place
    of its own build, so that both packages register against one tree."""
    def set_source(self, source):
        self._source = interop.as_points(source, device=self._device)
        self._nodes = interop.gmmtree_nodes_from_reference(
            *nodes, device=self._device)

    pgt.GMMTree.set_source = set_source
    return _spmd.rank_calls(device, calls)
