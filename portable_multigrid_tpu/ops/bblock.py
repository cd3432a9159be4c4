"""Rectangular block-banded matrices: pack + batched-matmul contraction.

The matmul form of every banded 1D factor in the framework: a banded
[R, C] matrix (assembled stiffness/mass, global nodal->quadrature
interpolation, collocation derivative, degree-embedding transfer) is
repacked into 128x128 block rows

    blocks[i]     : [128, KW*128]   (KW consecutive column blocks)
    col_start[i]  : first column block covered by block row i (static int)

so a 1D contraction along any tensor axis becomes ONE batched matmul
over block rows — O(KW * 128 * R * M) FLOPs instead of the dense O(R*C*M),
with XLA-friendly static gathers for the operand blocks.  This is what
makes the large-N 2D/variable-coefficient paths affordable without a
hand-written kernel: the contraction is pure dot_general + gather, so it
runs on any backend, under shard_map, and inside jit with small closure
constants (at r=9 the dense global 1D matrices are 300 MB, packed ~6 MB).

Exactness: packing partitions the zero-padded matrix, every entry lands in
exactly one block (no assembly/double-counting subtlety), so the block
contraction reproduces A @ x to roundoff.  Transposed applies pack A.T
through the same function — the restriction-is-exact-transpose invariant
then holds structurally.

Reference analog: the banded structure the reference exploits cell-locally
in its sum-factorized kernels (include/operators/portable_laplace_operator.h:
227-381); here it is hoisted to the global assembled/interpolation level.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

BLOCK = 128


def pack_rect(A: np.ndarray, block: int = BLOCK):
    """Pack a banded rectangular matrix [R, C] into block-banded form.

    Returns (blocks [nbr, block, KW*block] np.ndarray, col_start tuple of
    nbr ints, R, C).  KW is the smallest width covering every block row's
    nonzero column span (bandwidth must be < (KW-?)*block; asserted).
    """
    R, C = A.shape
    nbr = -(-R // block)
    nbc = -(-C // block)
    Ap = np.zeros((nbr * block, nbc * block), A.dtype)
    Ap[:R, :C] = A
    spans = []
    for i in range(nbr):
        rows = Ap[i * block : (i + 1) * block]
        nz = np.nonzero(np.any(rows != 0.0, axis=0))[0]
        if len(nz) == 0:
            spans.append((0, 1))
        else:
            j0, j1 = int(nz[0] // block), int(nz[-1] // block)
            spans.append((j0, j1 - j0 + 1))
    KW = min(max(w for _, w in spans), nbc)
    # widen the padded frame so every start fits KW blocks without clamping
    # against the right edge changing coverage
    if nbc < KW:
        extra = (KW - nbc) * block
        Ap = np.pad(Ap, ((0, 0), (0, extra)))
        nbc = KW
    starts = []
    for j0, w in spans:
        assert w <= KW
        starts.append(min(j0, nbc - KW))
    blocks = np.zeros((nbr, block, KW * block), A.dtype)
    for i in range(nbr):
        j0 = starts[i]
        blocks[i] = Ap[i * block : (i + 1) * block,
                       j0 * block : (j0 + KW) * block]
    return blocks, tuple(starts), R, C


def contract(
    t: jnp.ndarray,
    blocks: jnp.ndarray,
    col_start: tuple,
    R: int,
    C: int,
    ax: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """y = A @ x along axis ``ax`` of ``t`` (x extent C -> y extent R),
    with A in block-banded form.  One gather of operand block rows + one
    batched matmul."""
    assert t.shape[ax] == C, (t.shape, ax, C)
    nbr, block, KWb = blocks.shape
    KW = KWb // block
    t = jnp.moveaxis(t, ax, 0)
    rest = t.shape[1:]
    tp = t.reshape(C, -1)
    nbc = max(s for s in col_start) + KW
    if nbc * block != C:
        tp = jnp.pad(tp, ((0, nbc * block - C), (0, 0)))
    xb = tp.reshape(nbc, block, -1)
    # static operand-block index per block row: [nbr, KW]
    idx = np.asarray(col_start)[:, None] + np.arange(KW)[None, :]
    U = xb[jnp.asarray(idx)].reshape(nbr, KW * block, -1)
    y = jnp.einsum(
        "bij,bjm->bim", blocks, U,
        precision=precision, preferred_element_type=t.dtype,
    )
    y = y.reshape(nbr * block, -1)[:R].reshape((R,) + rest)
    return jnp.moveaxis(y, 0, ax)
