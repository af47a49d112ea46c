"""Closed-form small-matrix spectral ops (3x3 symmetric eigendecomposition,
3x3 SVD, dominant/smallest eigenvectors of small symmetric systems).

Batched programs cannot afford a LAPACK eigensolver per RANSAC hypothesis
(SURVEY.md §7.3 numerics; jnp.linalg.eigh compiles to slow batched
lowerings) — these are the pure-arithmetic equivalents used by the
geometric solvers: Cardano/trigonometric eigenvalues for 3x3 symmetric
matrices, eigenvectors by cross products, and shifted power iteration for
the 9x9 systems of the 8-point/DLT solvers. All batched over leading dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


def eigh3x3(A: jnp.ndarray):
    """Eigenvalues (ascending) + eigenvectors of symmetric [..., 3, 3].

    Trigonometric (Cardano) closed form for the eigenvalues; eigenvectors
    from cross products of (A - lam I) rows with degeneracy fallbacks.
    Returns (w [..., 3], V [..., 3, 3]) with columns V[..., :, i].
    """
    A = 0.5 * (A + jnp.swapaxes(A, -1, -2))
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    Bn = B / p[..., None, None]
    detBn = jnp.linalg.det(Bn)
    r = jnp.clip(detBn / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    w2 = q + 2.0 * p * jnp.cos(phi)                      # largest
    w0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2
    w = jnp.stack([w0, w1, w2], axis=-1)

    def eigvec(lam):
        M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
        # Candidate vectors: cross products of row pairs.
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = jnp.cross(r0, r1)
        c02 = jnp.cross(r0, r2)
        c12 = jnp.cross(r1, r2)
        cands = jnp.stack([c01, c02, c12], axis=-2)      # [..., 3, 3]
        norms = jnp.linalg.norm(cands, axis=-1)
        best = jnp.argmax(norms, axis=-1)
        v = jnp.take_along_axis(
            cands, best[..., None, None].repeat(3, -1), axis=-2
        )[..., 0, :]
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        # Degenerate (repeated eigenvalue): any unit vector orthogonalized
        # later is fine; fall back to e1.
        e1 = jnp.zeros_like(v).at[..., 0].set(1.0)
        return jnp.where(n > 1e-12, v / jnp.maximum(n, 1e-30), e1)

    v0 = eigvec(w[..., 0])
    v2 = eigvec(w[..., 2])
    # Middle eigenvector: orthogonal complement (robust to degeneracy).
    v1 = jnp.cross(v2, v0)
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    v1 = jnp.where(n1 > 1e-12, v1 / jnp.maximum(n1, 1e-30),
                   eigvec(w[..., 1]))
    V = jnp.stack([v0, v1, v2], axis=-1)
    return w, V


def svd3x3(M: jnp.ndarray):
    """SVD of [..., 3, 3]: returns (U, s desc [..., 3], V) with
    M = U diag(s) V^T, via eigh3x3 of M^T M (V) and U = M V / s with
    orthogonal completion for tiny singular values."""
    w, V = eigh3x3(jnp.einsum("...ji,...jk->...ik", M, M, precision=_PREC))
    # Ascending eigenvalues -> descending singular values.
    s = jnp.sqrt(jnp.maximum(w[..., ::-1], 0.0))
    V = V[..., ::-1]
    MV = jnp.einsum("...ij,...jk->...ik", M, V, precision=_PREC)
    U0 = MV[..., :, 0] / jnp.maximum(s[..., 0:1], 1e-12)
    U1 = MV[..., :, 1] / jnp.maximum(s[..., 1:2], 1e-12)
    # Orthonormalize defensively; U2 from the cross product (also fixes the
    # rank-2 case where s2 ~ 0).
    U0 = U0 / jnp.maximum(jnp.linalg.norm(U0, axis=-1, keepdims=True), 1e-12)
    U1 = U1 - jnp.sum(U0 * U1, -1, keepdims=True) * U0
    U1 = U1 / jnp.maximum(jnp.linalg.norm(U1, axis=-1, keepdims=True), 1e-12)
    U2 = jnp.cross(U0, U1)
    # The cross product fixes U2 only up to sign; align it with M v2 so the
    # third singular value stays non-negative (sign irrelevant when s2 ~ 0).
    sgn = jnp.sign(jnp.sum(U2 * MV[..., :, 2], -1, keepdims=True))
    U2 = U2 * jnp.where(sgn == 0, 1.0, sgn)
    U = jnp.stack([U0, U1, U2], axis=-1)
    return U, s, V


def smallest_eigvec_sym(M: jnp.ndarray, n_iters: int = 12):
    """Smallest-eigenvalue eigenvector of symmetric PSD [..., D, D] via
    INVERSE power iteration: x <- (M + eps I)^-1 x. Converges at rate
    (lam0+eps)/(lam1+eps) — for the null-vector systems of the 8-point /
    DLT solvers lam0 ~ 0, so a handful of iterations suffice (a forward
    power iteration on the complement stalls when the spectrum is wide).
    Batched small solves (D<=9) lower to fast triangular kernels."""
    D = M.shape[-1]
    tr = jnp.trace(M, axis1=-2, axis2=-1)
    eps = (1e-9 * tr + 1e-30)[..., None, None]
    A = M + eps * jnp.eye(D, dtype=M.dtype)
    v = jnp.ones(M.shape[:-1], M.dtype)

    def body(v, _):
        v = jnp.linalg.solve(A, v[..., None])[..., 0]
        return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30), None

    v, _ = jax.lax.scan(body, v, None, length=n_iters)
    return v
