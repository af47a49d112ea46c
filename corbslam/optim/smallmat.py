"""Unrolled fixed-size symmetric linear algebra (3x3 / 6x6 / 7x7).

BA needs thousands of tiny SPD solves (per-point 3x3 Hessians, per-camera
6x6 preconditioner blocks). Batched LAPACK-style lowerings are the wrong
tool here (see the eigh compile pathology noted in geometry/camera.py);
these are Cholesky factorizations unrolled at trace time into pure
elementwise ops — they vmap/fuse like arithmetic because they are
arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_unrolled(A: jnp.ndarray, n: int, eps: float = 1e-12) -> jnp.ndarray:
    """Batched Cholesky of SPD [..., n, n] via unrolled scalar recurrences."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                L[i][j] = s / L[j][j]
    rows = []
    for i in range(n):
        cols = [L[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0]) for j in range(n)]
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def chol_solve_factored(Lm: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Solve with a precomputed Cholesky factor L (lower), unrolled."""
    L = [[Lm[..., i, j] for j in range(n)] for i in range(n)]
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # backward: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def chol_solve_unrolled(A: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Solve SPD A x = b, A [..., n, n], b [..., n], fully unrolled."""
    return chol_solve_factored(chol_unrolled(A, n), b, n)


def inv_spd_unrolled(A: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse of SPD [..., n, n] by solving against the identity columns."""
    eye = jnp.eye(n, dtype=A.dtype)
    cols = [chol_solve_unrolled(A, jnp.broadcast_to(eye[i], A.shape[:-2] + (n,)), n) for i in range(n)]
    return jnp.stack(cols, axis=-1)
