"""Chunked callback loops (counterpart of probreg_tpu/utils/chunked.py).

A callback loop that reads the device once per EM iteration (for the stop
test, or to hand the callbacks a host value) synchronizes the CUDA stream
each time: the host waits for the iteration to finish before it can queue
the next, so the card idles while Python runs the callbacks and launches
the next iteration's kernels one by one. ``run_chunked`` keeps the
per-iteration callback semantics but reads the device once per chunk of K
iterations: a family's ``chunk_fn`` queues K iterations with no host read
between them and returns the stacked per-iteration history, the host
copies that history with ONE ``.cpu()``, then replays the callbacks and
the stop test iteration by iteration. Each family's chunk runs the same
step as its K = 1 loop, so callbacks see the same transforms, bit for
bit, for every K.

``FETCHES`` counts the host copies (one per chunk).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

FETCHES = 0


def reset_fetches() -> None:
    global FETCHES
    FETCHES = 0


def stack_history(rows: Sequence[Sequence[torch.Tensor]]):
    """Per-iteration rows (tuples of tensors) -> a tuple of tensors with a
    leading iteration axis."""
    return tuple(torch.stack(parts) for parts in zip(*rows))


def fetch(hist: Sequence[torch.Tensor]):
    """The history on the host in ONE copy: every leaf flattened into one
    buffer of the widest floating dtype among them (exact for float32,
    float64 and flags), copied once, split and cast back."""
    global FETCHES
    k = hist[0].shape[0]
    wide = torch.float64 if any(h.dtype == torch.float64 for h in hist) \
        else torch.float32
    flat = torch.cat([h.reshape(k, -1).to(wide) for h in hist], 1).cpu()
    FETCHES += 1
    out, col = [], 0
    for h in hist:
        width = h[0].numel()
        out.append(flat[:, col:col + width].reshape(h.shape).to(h.dtype))
        col += width
    return tuple(out)


def run_chunked(chunk_fn: Callable, state, maxiter: int, chunk: int,
                handle: Callable):
    """Drive ``chunk_fn`` in chunks and replay the per-iteration host work.

    Args:
        chunk_fn: ``chunk_fn(state, k) -> (state, hist)`` queues ``k``
            iterations on the device with no host read between them;
            ``hist`` is a tuple of tensors with a leading ``k`` axis.
        state: The starting device state.
        maxiter: Total iteration budget.
        chunk: Iterations per chunk (K); 1 is the K = 1 loop.
        handle: ``handle(i, host, j) -> (stop, result)`` for the global
            iteration ``i``: row ``j`` of the host copy ``host`` of the
            history; runs the callbacks and the stop test. ``result`` is
            that iteration's result. (Device tensors of the iteration, a
            transformation for the callbacks, stay with the family's
            ``chunk_fn``.)

    Returns:
        The ``result`` of the last handled iteration (None if ``maxiter``
        is 0). The last chunk holds only the iterations left of
        ``maxiter``; a chunk's iterations after the stop test fires are
        run and not replayed.
    """
    chunk = max(1, int(chunk))
    it = 0
    result = None
    while it < maxiter:
        k = min(chunk, int(maxiter) - it)
        state, hist = chunk_fn(state, k)
        host = fetch(hist)
        for j in range(k):
            stop, result = handle(it + j, host, j)
            if stop:
                return result
        it += k
    return result


def slice_tree(tree, j: int):
    """Row ``j`` of every leaf of a stacked history (a tuple, list or dict
    of tensors or arrays; reference chunked.py:72)."""
    if isinstance(tree, dict):
        return {k: slice_tree(v, j) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        rows = [slice_tree(v, j) for v in tree]
        return type(tree)(*rows) if hasattr(tree, "_fields") \
            else type(tree)(rows)
    return tree[j]
