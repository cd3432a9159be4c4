"""Structured-grid gather/scatter primitives (JAX, device-side).

JAX replacement for the reference's indexed gather / atomic-or-colored
scatter of cell DoFs (reference:
include/operators/portable_laplace_operator.h:245-258 [gather via
local_to_global] and :361-380 [Kokkos::atomic_add or colored scatter]).

On a structured mesh, continuous Q_p DoFs form a tensor grid; extracting the
per-cell DoF patches is a pair of reshapes/strided slices per axis, and the
transpose "assembly" (scatter-add) is an overlap-add, also expressible with
reshapes and one shifted add per axis — no gather/scatter HLO, no atomics,
no cell coloring.  This deletes the reference's entire per-color machinery
(SURVEY.md §2.3 item 3); the summation order is fixed by the program,
not by thread scheduling.

All windows here have width == stride + 1 (the one-point C0 overlap between
neighboring cells), which both the operator (stride p) and the transfers
(stride p or 2p) satisfy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls may default to reduced-precision passes (TF32 on a GPU); the
# solver needs true f32/f64 contractions (the reference is f64 end-to-end,
# SURVEY.md §7 point 4).
PRECISION = jax.lax.Precision.HIGHEST


def split_windows(u: jnp.ndarray, axis: int, n: int, stride: int) -> jnp.ndarray:
    """Grid axis of length n*stride+1 -> overlapping windows [n, stride+1].

    The cell axis replaces ``axis``; the window axis is inserted at ``axis+1``.
    Pure reshape + two slices (adjacent windows share exactly one point).
    """
    s = stride
    u = jnp.moveaxis(u, axis, 0)
    body = u[: n * s].reshape((n, s) + u.shape[1:])
    last = u[s :: s][:, None]
    w = jnp.concatenate([body, last], axis=1)  # [n, s+1, ...]
    return jnp.moveaxis(w, (0, 1), (axis, axis + 1))


def overlap_add(v: jnp.ndarray, axis: int, n: int, stride: int) -> jnp.ndarray:
    """Transpose of :func:`split_windows`: windows [n(axis), s+1(axis+1)] -> grid.

    Deterministic scatter-add replacement: out[i*s + j] += v[i, j].
    """
    s = stride
    v = jnp.moveaxis(v, (axis, axis + 1), (0, 1))  # [n, s+1, ...]
    rest = v.shape[2:]
    flat = v[:, :s].reshape((n * s,) + rest)
    left = jnp.concatenate([flat, jnp.zeros((1,) + rest, v.dtype)], axis=0)
    # contributions of each window's last point land at (i+1)*s
    lastcol = v[:, s]
    if s > 1:
        interior = jnp.concatenate(
            [lastcol[: n - 1, None], jnp.zeros((n - 1, s - 1) + rest, v.dtype)],
            axis=1,
        ).reshape(((n - 1) * s,) + rest)
    else:
        interior = lastcol[: n - 1]
    tail = jnp.concatenate(
        [jnp.zeros((s,) + rest, v.dtype), interior, lastcol[n - 1 : n]], axis=0
    )
    return jnp.moveaxis(left + tail, 0, axis)


def contract(
    t: jnp.ndarray, M: jnp.ndarray, axis: int, precision=None
) -> jnp.ndarray:
    """Apply the 1D matrix M[out, in] along ``axis`` of t (sum-factorization step).

    The jnp analog of one ``EvaluatorTensorProduct::values<direction>`` /
    ``co_gradients<direction>`` pass (reference:
    include/operators/portable_laplace_operator.h:281-296).
    """
    out = jnp.tensordot(
        t, M, axes=((axis,), (1,)), precision=precision or PRECISION
    )
    return jnp.moveaxis(out, -1, axis)


def split_all(
    u: jnp.ndarray, dim: int, n: tuple[int, ...], stride: int
) -> jnp.ndarray:
    """Split every grid axis: [n_d*s+1]*dim -> interleaved [n_d, s+1] layout.

    ``n`` gives the cell count per axis (they differ on sharded slabs).
    Cell axes land at even positions (0, 2, 4), DoF axes at odd (1, 3, 5).
    """
    for d in range(dim):
        u = split_windows(u, 2 * d, n[d], stride)
    return u


def overlap_add_all(
    v: jnp.ndarray, dim: int, n: tuple[int, ...], stride: int
) -> jnp.ndarray:
    """Inverse of :func:`split_all` (with summation on shared points)."""
    for d in reversed(range(dim)):
        v = overlap_add(v, 2 * d, n[d], stride)
    return v
