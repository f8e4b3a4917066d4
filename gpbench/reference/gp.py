"""Plain PyTorch reference of the exact GP's BBMM computations, in float64.

Independent of the program: it imports nothing but ``torch`` and works out
again, from the inputs the harness hands to both sides, what the program
derives from them — the Matérn-5/2 kernel matrix, mBCG solves with their
Lanczos tridiagonals, the SLQ log-determinant, the BBMM gradient
estimator, Adam, the rank-k pivoted-Cholesky preconditioner, preconditioned
CG for the posterior weights (a full build and a warm-started append) and
the cached posterior mean and variance.

``rounding`` lowers the precision of every product (its operands rounded,
the sum kept in float64): ``"tf32"`` rounds to TF32's 10-bit mantissa,
``"fp8"`` to float8 e4m3 with one scale per tensor.  The harness runs these
as the control that a comparison has to reject.

Semantics followed (the algorithm, not any implementation of it):

* K̂ = s·k(‖x − x'‖/ℓ) + σ²I with k(r) = (1 + √5r + 5r²/3)·exp(−√5r), the
  distance floored at 1e-10;
* mBCG: each column its own CG (preconditioned or not), a fixed trip
  count, a column frozen once its relative residual is at or below tol;
* T̃ from the CG coefficients (identity-padded after convergence), log|K̂|
  ≈ (1/t)Σᵢ ‖zᵢ‖²·e₁ᵀlog(T̃ᵢ)e₁ with eigenvalues floored at 1e-10;
* the loss ½(yᵀu + log|K̂| + n·log 2π) and its BBMM gradient
  ½(−uᵀ∂K̂u + (1/t)Σᵢ zᵢᵀ∂K̂sᵢ), sᵢ the probe solves;
* probes: Rademacher columns drawn as ``2·randint(0, 2, (n, t)) − 1`` from
  the generator the run is seeded with, one draw per step.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
SQRT5 = math.sqrt(5.0)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
EIG_FLOOR = 1e-10
LEAVES = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: float) -> float:
    return math.log(math.expm1(y))


# --------------------------------------------------------------------------
# precision of the control
# --------------------------------------------------------------------------


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even), in x's
    dtype."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32).to(x.dtype)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude mapped to 448, e4m3's largest value)."""
    amax = torch.clamp(x.abs().amax(), min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


ROUNDINGS = {None: None, "tf32": round_tf32, "fp8": round_fp8}


def _rounder(rounding):
    fn = ROUNDINGS[rounding]
    if fn is None:
        return lambda x: x
    # straight through: the rounding's error carries into the value, the
    # derivative is that of the unrounded operand
    return lambda x: x + (fn(x.detach()) - x.detach())


# --------------------------------------------------------------------------
# the kernel matrix
# --------------------------------------------------------------------------


def matern52(d2: torch.Tensor, outputscale) -> torch.Tensor:
    a = SQRT5 * torch.sqrt(torch.clamp(d2, min=1e-20))
    return outputscale * (1.0 + a + a * a / 3.0) * torch.exp(-a)


class KernelMatrix:
    """K̂ = K(X, X) + σ²I for one parameter set, formed in row blocks.

    ``lengthscale`` / ``outputscale`` / ``noise`` are the constrained
    values (tensors, possibly requiring grad).  ``rounding`` lowers the
    inner products and the products' operands (the control).  With
    ``dense`` the matrix is formed once and kept (n² float64)."""

    def __init__(self, X, lengthscale, outputscale, noise, *, rounding=None, block=4096,
                 dense=False):
        self.X = X.to(F64)
        self.n = self.X.shape[0]
        self.lengthscale, self.outputscale, self.noise = lengthscale, outputscale, noise
        self.r = _rounder(rounding)
        self.block = block
        self._K = None
        if dense:
            K = torch.empty((self.n, self.n), dtype=F64, device=self.X.device)
            for i0 in range(0, self.n, block):
                i1 = min(i0 + block, self.n)
                K[i0:i1] = self.r(self.rows(i0, i1)).detach()
            self._K = K

    def _scaled(self, X):
        return self.r(X.to(F64) / self.lengthscale)

    def cross(self, A, B, *, add_noise_from=None):
        """k(A, B) (|A| × |B|); with ``add_noise_from`` = i0 the σ² diagonal
        of rows i0.. of the square matrix is added."""
        Za, Zb = self._scaled(A), self._scaled(B)
        d2 = (Za * Za).sum(-1)[:, None] + (Zb * Zb).sum(-1)[None, :] - 2.0 * (Za @ Zb.T)
        K = matern52(torch.clamp(d2, min=0.0), self.outputscale)
        if add_noise_from is not None:
            rows = torch.arange(K.shape[0], device=K.device)
            diag = (rows[:, None] + add_noise_from) == torch.arange(K.shape[1], device=K.device)
            K = K + self.noise * diag
        return K

    def rows(self, i0, i1):
        return self.cross(self.X[i0:i1], self.X, add_noise_from=i0)

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        """K̂ @ M for M (n, c)."""
        M = self.r(M.to(F64))
        if self._K is not None:
            return self._K @ M
        out = []
        for i0 in range(0, self.n, self.block):
            out.append(self.r(self.rows(i0, min(i0 + self.block, self.n))) @ M)
        return torch.cat(out)

    def base_row(self, i: int) -> torch.Tensor:
        """Row i of K (no noise), unrounded: the preconditioner's pivot row."""
        x = self.X[i:i + 1] / self.lengthscale
        Z = self.X / self.lengthscale
        d2 = (x * x).sum(-1)[:, None] + (Z * Z).sum(-1)[None, :] - 2.0 * (x @ Z.T)
        return matern52(torch.clamp(d2, min=0.0), self.outputscale)[0]


# --------------------------------------------------------------------------
# mBCG, SLQ
# --------------------------------------------------------------------------


def mbcg(matmul, B: torch.Tensor, *, max_iters: int, tol, precond_solve=None):
    """Solves of K̂U = B for every column of B (n, c), each column its own
    (preconditioned) CG with a fixed trip count.  Returns (U, alphas,
    betas, actives), the last three (c, p)."""
    psolve = precond_solve or (lambda R: R)
    B = B.to(F64)
    b_norm = torch.linalg.vector_norm(B, dim=0)
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    tol = torch.as_tensor(tol, dtype=F64, device=B.device)
    U = torch.zeros_like(B)
    R = B
    Z = psolve(R)
    D = Z
    rz = (R * Z).sum(0)
    active = torch.linalg.vector_norm(R, dim=0) / b_norm > tol
    alphas, betas, actives = [], [], []
    zero = torch.zeros_like(rz)
    for _ in range(max_iters):
        V = matmul(D)
        dv = (D * V).sum(0)
        alpha = torch.where(active, rz / torch.where(dv == 0, torch.ones_like(dv), dv), zero)
        U = U + alpha * D
        R = R - alpha * V
        Znew = psolve(R)
        rz_new = (R * Znew).sum(0)
        beta = torch.where(active, rz_new / torch.where(rz == 0, torch.ones_like(rz), rz), zero)
        D = torch.where(active, Znew + beta * D, D)
        alphas.append(alpha)
        betas.append(beta)
        actives.append(active)
        res = torch.linalg.vector_norm(R, dim=0) / b_norm
        rz = torch.where(active, rz_new, rz)
        active = active & (res > tol)
    return U, torch.stack(alphas, -1), torch.stack(betas, -1), torch.stack(actives, -1)


def tridiagonals(alphas, betas, actives) -> torch.Tensor:
    """The (c, p, p) Lanczos tridiagonals from the CG coefficients."""
    p = alphas.shape[-1]
    inv_a = torch.where(alphas != 0, 1.0 / torch.where(alphas != 0, alphas, torch.ones_like(alphas)),
                        torch.zeros_like(alphas))
    pad = torch.nn.functional.pad
    diag = inv_a + pad(betas[:, :-1], (1, 0)) * pad(inv_a[:, :-1], (1, 0))
    diag = torch.where(actives, diag, torch.ones_like(diag))
    off = torch.sqrt(torch.clamp(betas[:, :-1], min=0.0)) * inv_a[:, :-1]
    off = torch.where(actives[:, 1:], off, torch.zeros_like(off))
    T = torch.diag_embed(diag)
    idx = torch.arange(p - 1, device=T.device)
    T[:, idx, idx + 1] = off
    T[:, idx + 1, idx] = off
    return T


def slq_logdet(alphas, betas, actives, Z) -> torch.Tensor:
    evals, evecs = torch.linalg.eigh(tridiagonals(alphas, betas, actives))
    quad = (evecs[:, 0, :] ** 2 * torch.log(torch.clamp(evals, min=EIG_FLOOR))).sum(-1)
    return torch.mean((Z.to(F64) ** 2).sum(0) * quad)


# --------------------------------------------------------------------------
# training: the loss, its gradient, Adam
# --------------------------------------------------------------------------


def draw_probes(generator: torch.Generator, n: int, t: int, device) -> torch.Tensor:
    bits = torch.randint(0, 2, (n, t), generator=generator, device=device)
    return (2 * bits - 1).to(F64)


def _constrained(raw):
    return softplus(raw["raw_lengthscale"]), softplus(raw["raw_outputscale"]), softplus(
        raw["raw_noise"])


def loss_and_grad(X, y, raw: dict, Z, *, max_iters: int, tol: float, rounding=None,
                  block=2048, dense=True):
    """(loss, {leaf: gradient}) of one BBMM training step at ``raw``."""
    X, y = X.to(F64), y.to(F64)
    n = X.shape[0]
    ell, s, sig2 = (v.detach() for v in _constrained(raw))
    K = KernelMatrix(X, ell, s, sig2, rounding=rounding, dense=dense)
    U, alphas, betas, actives = mbcg(K.matmul, torch.cat([y[:, None], Z], 1),
                                     max_iters=max_iters, tol=tol)
    del K
    u, S = U[:, 0], U[:, 1:]
    logdet = slq_logdet(alphas[1:], betas[1:], actives[1:], Z)
    loss = 0.5 * (torch.dot(y, u) + logdet + n * math.log(2.0 * math.pi))

    leaves = {k: raw[k].detach().clone().requires_grad_() for k in LEAVES}
    t = Z.shape[1]
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        Kg = KernelMatrix(X, *_constrained(leaves), rounding=rounding)  # a graph per block
        Kb, r = Kg.rows(i0, i1), Kg.r
        surrogate = 0.5 * (-(u[i0:i1] @ (r(Kb) @ r(u[:, None])))[0]
                           + ((Z[i0:i1] * (r(Kb) @ r(S))).sum()) / t)
        got = torch.autograd.grad(surrogate, [leaves[k] for k in LEAVES])
        for k, g in zip(LEAVES, got):
            grads[k] += g
    return float(loss), {k: g.detach() for k, g in grads.items()}


def train_reference(X, y, raw0: dict, probe_generator, *, steps: int, lr: float,
                    num_probes: int, max_iters: int, tol: float, rounding=None, dense=True):
    """The first ``steps`` Adam steps of the BBMM fit from ``raw0``.

    Returns {"losses": [...], "grads": [{leaf: g}, ...], "params": [{leaf:
    value after step k}, ...]}."""
    device = X.device
    raw = {k: torch.as_tensor(raw0[k], dtype=F64, device=device).clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    v2 = {k: torch.zeros_like(v) for k, v in raw.items()}
    b1, b2 = ADAM_BETAS
    out = {"losses": [], "grads": [], "params": []}
    for k in range(1, steps + 1):
        Z = draw_probes(probe_generator, X.shape[0], num_probes, device)
        loss, g = loss_and_grad(X, y, raw, Z, max_iters=max_iters, tol=tol, rounding=rounding,
                                dense=dense)
        for name in LEAVES:
            m[name] = b1 * m[name] + (1 - b1) * g[name]
            v2[name] = b2 * v2[name] + (1 - b2) * g[name] ** 2
            mhat = m[name] / (1 - b1 ** k)
            vhat = v2[name] / (1 - b2 ** k)
            raw[name] = raw[name] - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        out["losses"].append(loss)
        out["grads"].append(g)
        out["params"].append({name: raw[name].clone() for name in LEAVES})
    return out


# --------------------------------------------------------------------------
# serving: the preconditioner, the posterior weights, the cached answers
# --------------------------------------------------------------------------


def pivoted_cholesky(K: KernelMatrix, rank: int, jitter: float) -> torch.Tensor:
    """Greedy rank-``rank`` pivoted Cholesky of the base kernel K (no
    noise): L (n, rank), K ≈ LLᵀ."""
    n = K.n
    d = torch.full((n,), float(K.outputscale), dtype=F64, device=K.X.device)
    L = torch.zeros((n, rank), dtype=F64, device=K.X.device)
    picked = torch.zeros(n, dtype=torch.bool, device=K.X.device)
    for j in range(rank):
        piv = int(torch.argmax(torch.where(picked, torch.full_like(d, -math.inf), d)))
        dpiv = max(float(d[piv]), 0.0)
        if dpiv <= jitter:
            break
        col = (K.base_row(piv) - L @ L[piv]) / math.sqrt(dpiv)
        col[picked] = 0.0
        col[piv] = math.sqrt(dpiv)
        L[:, j] = col
        d = d - col * col
        picked[piv] = True
    return L


def woodbury_solve(L: torch.Tensor, sigma2):
    """R ↦ (LLᵀ + σ²I)⁻¹R."""
    k = L.shape[1]
    C = torch.linalg.cholesky(sigma2 * torch.eye(k, dtype=F64, device=L.device) + L.T @ L)

    def solve(R):
        return (R - L @ torch.cholesky_solve(L.T @ R, C)) / sigma2

    return solve


def posterior_weights(X, y, ell, s, sig2, *, rank: int, jitter: float, max_iters: int,
                      tol: float, rounding=None, u0=None, dense=True) -> torch.Tensor:
    """α ≈ K̂⁻¹y by preconditioned CG: a full build (``u0`` None) or an
    append warm-started from ``u0`` (the previous weights, zero-padded),
    which solves the residual to the same target ‖y − K̂α‖ ≤ tol·‖y‖."""
    y = y.to(F64)
    K = KernelMatrix(X, ell, s, sig2, rounding=rounding, dense=dense)
    psolve = woodbury_solve(pivoted_cholesky(K, rank, jitter), sig2) if rank > 0 else None
    if u0 is None:
        U = mbcg(K.matmul, y[:, None], max_iters=max_iters, tol=tol, precond_solve=psolve)[0]
        return U[:, 0]
    u0 = u0.to(F64)
    r0 = y - K.matmul(u0[:, None])[:, 0]
    tol_eff = tol * torch.linalg.vector_norm(y) / torch.clamp(torch.linalg.vector_norm(r0),
                                                               min=1e-30)
    U = mbcg(K.matmul, r0[:, None], max_iters=max_iters, tol=tol_eff, precond_solve=psolve)[0]
    return u0 + U[:, 0]


def cached_answer(X, Xstar, ell, s, sig2, alpha, basis, gram_chol, *, rounding=None):
    """The served (mean, variance) at Xstar from a cache's weights and
    Rayleigh–Ritz pair: mean k*ᵀα, variance s − v ᵀG⁻¹v + σ² with v =
    basisᵀk*, G = CCᵀ, the latent part floored at 1e-8."""
    K = KernelMatrix(X, ell, s, sig2, rounding=rounding)
    r = K.r
    Kxs = K.cross(X, Xstar)
    mean = r(Kxs).T @ r(alpha.to(F64))
    v = r(basis.to(F64)).T @ r(Kxs)
    w = torch.cholesky_solve(v, gram_chol.to(F64))
    var = torch.clamp(s - (v * w).sum(0), min=1e-8) + sig2
    return mean, var


def build_gram(X, ell, s, sig2, basis, *, rounding=None, dense=False) -> torch.Tensor:
    """The full build's Gram basisᵀK̂basis, symmetrised, with its jitter
    1e-6·tr/m on the diagonal."""
    K = KernelMatrix(X, ell, s, sig2, rounding=rounding, dense=dense)
    B = basis.to(F64)
    G = K.r(B).T @ K.matmul(B)
    G = 0.5 * (G + G.T)
    m = G.shape[0]
    return G + 1e-6 * torch.trace(G) / m * torch.eye(m, dtype=F64, device=G.device)
