"""Exact linear-sum assignment (Jonker-Volgenant), in numpy on the host.

The port's own copy of ``pautdx/ops/lapjv.py``. The JAX package solves on
the device because a host callback breaks its SPMD partitioning; on the
GPU the solve is thousands of serial, tiny steps (M rows, each an
augmenting-path search over Q columns), which eager launches would make
cost far more than one host round trip. So the DETR criterion copies the
costs of all its heads to the host in one transfer and solves them here,
all problems of a batch at once in vectorized numpy.

The arithmetic is the reference's, step for step in float32 (the same
shortest-augmenting-path iterations, the same first-index ``argmin``), so
:func:`lapjv_batch` returns exactly what ``pautdx.ops.lapjv.lapjv_batch``
returns. A problem that has finished keeps its state while the others
iterate, as the reference's ``vmap``-ed ``while_loop`` does.
"""

from __future__ import annotations

import numpy as np


def lapjv_batch(cost: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment of M rows to Q columns (M <= Q) for each
    of the leading problems: (..., M, Q) finite costs -> (..., M) int32,
    the column of each row; a problem's columns are distinct."""
    cost = np.asarray(cost, np.float32)
    *lead, M, Q = cost.shape
    if M > Q:
        raise ValueError(f"lapjv needs M <= Q, got {cost.shape[-2:]}")
    cost = cost.reshape(-1, M, Q)
    N = cost.shape[0]
    ar = np.arange(N)
    inf = np.float32(np.inf)
    zero = np.float32(0.0)
    # 1-indexed columns; column 0 is the virtual root of augmenting paths.
    # p[n, j] = row (1-indexed) of problem n assigned to column j, 0 = free.
    u = np.zeros((N, M + 1), np.float32)
    v = np.zeros((N, Q + 1), np.float32)
    p = np.zeros((N, Q + 1), np.int32)
    for i in range(1, M + 1):
        p[:, 0] = i
        minv = np.full((N, Q + 1), inf, np.float32)
        way = np.zeros((N, Q + 1), np.int32)
        used = np.zeros((N, Q + 1), bool)
        j0 = np.zeros(N, np.int64)
        active = p[ar, j0] != 0
        while active.any():
            act = active[:, None]
            used_n = used.copy()
            used_n[ar, j0] = True
            i0 = p[ar, j0]
            # a finished problem computes with i0 = 0 here; every update
            # below is masked by ``active``
            cur = cost[ar, i0 - 1, :] - u[ar, i0][:, None] - v[:, 1:]
            better = (cur < minv[:, 1:]) & ~used_n[:, 1:]
            minv_n = minv.copy()
            minv_n[:, 1:] = np.where(better, cur, minv[:, 1:])
            way_n = way.copy()
            way_n[:, 1:] = np.where(better, j0[:, None], way[:, 1:])
            masked = np.where(used_n[:, 1:], inf, minv_n[:, 1:])
            j1 = np.argmin(masked, axis=1) + 1
            delta = masked[ar, j1 - 1]
            step = np.where(used_n & act, delta[:, None], zero)
            # u[p] += step: the used columns hold distinct rows, the others
            # add 0
            np.add.at(u, (np.broadcast_to(ar[:, None], p.shape), p), step)
            v = v - step
            minv_n = minv_n - np.where(used_n, zero, delta[:, None])
            minv = np.where(act, minv_n, minv)
            way = np.where(act, way_n, way)
            used = np.where(act, used_n, used)
            j0 = np.where(active, j1, j0)
            active = p[ar, j0] != 0
        # augment along ``way`` back to the root
        going = j0 != 0
        while going.any():
            n = ar[going]
            j1 = way[n, j0[n]]
            p[n, j0[n]] = p[n, j1]
            j0[n] = j1
            going = j0 != 0
    # invert: ans[row] = column
    ans = np.zeros((N, M), np.int32)
    n, j = np.nonzero(p[:, 1:] > 0)
    ans[n, p[n, j + 1] - 1] = j
    return ans.reshape(*lead, M)

