"""Plain PyTorch versions of the SSD scan — the counterparts of
``repro.kernels.ssd_scan.ref``:

``ssd_scan_ref``         the step-by-step recurrence (the ground truth);
``ssd_scan_chunked_ref`` the chunked reformulation, the CUDA-core kernel's
                         arithmetic in plain torch; the kernel's wrapper runs
                         it on CPU tensors.  Both take the decay between
                         steps j and i from a direct sum of dt·A over (j, i],
                         where the reference takes a difference of
                         cumulative sums;
``ssd_scan_tc_ref``      the tensor-core kernel's arithmetic in plain torch
                         (its blocked decays from ``ssd_tc_decays``, the f32
                         operands split into bf16 high and low halves, f32
                         accumulation), for the tests.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, B, C):
    """x (b,h,l,dh), dt (b,h,l), A (h,), B/C (b,l,ds) → y (b,h,l,dh).

    h_t = exp(Δ_t·A)·h_{t-1} + Δ_t·(x_t ⊗ B_t), y_t = h_t @ C_t, in f32
    (in f64 for f64 inputs: the witness ``chip_smoke.py`` holds the
    kernel and the chunked version to)."""
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    x32, dt32 = x.to(ct), dt.to(ct)
    B32, C32, A32 = B.to(ct), C.to(ct), A.to(ct)
    state = torch.zeros((b, h, dh, ds), dtype=ct, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dt32[:, :, t] * A32[None, :])[..., None, None]
        outer = x32[:, :, t, :, None] * B32[:, None, None, t, :]  # (b,h,dh,ds)
        state = decay * state + dt32[:, :, t, None, None] * outer
        ys.append(torch.einsum("bhds,bs->bhd", state, C32[:, t]))
    return torch.stack(ys, dim=2).to(x.dtype)


def ssd_scan_chunked_ref(x, dt, A, B, C, *, chunk=64):
    """The chunked SSD in plain torch (mirrors the kernel's math), in f32
    (f64 for f64 inputs)."""
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_scan: length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk

    ct = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct).reshape(b, h, nc, chunk, dh)
    dt32 = dt.to(ct).reshape(b, h, nc, chunk)
    B32 = B.to(ct).reshape(b, nc, chunk, ds)
    C32 = C.to(ct).reshape(b, nc, chunk, ds)
    A32 = A.to(ct)

    la = dt32 * A32[None, :, None, None]  # (b,h,nc,c)
    cum = torch.cumsum(la, dim=-1)
    total = cum[..., -1]

    # seg[i, j] = la_{j+1} + … + la_i for i ≥ j (0 above the diagonal, so
    # no exponent is positive), summed directly: the reference's cum_i −
    # cum_j keeps only ~1e-4 absolute of it where the cumulative sums reach
    # −10³ within a chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    below = torch.tril(tri, diagonal=-1)
    seg = torch.cumsum(torch.where(below, la[..., :, None], 0.0), dim=-2)  # (b,h,nc,c,c)

    # intra-chunk
    G = torch.einsum("bnis,bnjs->bnij", C32, B32)  # (b,nc,c,c)
    decay = torch.exp(seg) * tri
    M = G[:, None] * decay * dt32[..., None, :]
    y = torch.einsum("bhnij,bhnjd->bhnid", M, x32)

    # the states carried across chunks
    coef = torch.exp(seg[..., -1, :]) * dt32  # (b,h,nc,c)
    chunk_state = torch.einsum("bhncd,bncs,bhnc->bhnds", x32, B32, coef)
    state = torch.zeros((b, h, dh, ds), dtype=ct, device=x.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(state)  # the state *before* chunk n
        state = torch.exp(total[:, :, n])[..., None, None] * state + chunk_state[:, :, n]
    h_prev = torch.stack(h_prevs, dim=2)  # (b,h,nc,dh,ds)

    y_inter = torch.einsum("bnis,bhnds->bhnid", C32, h_prev)
    y = y + torch.exp(cum)[..., None] * y_inter
    return y.reshape(b, h, l, dh).to(x.dtype)


def _exclusive_suffix(v):
    """Σ_{m > k} v_m along the last dim, summed directly (no difference)."""
    inclusive = torch.cumsum(v.flip(-1), dim=-1).flip(-1)
    return torch.cat([inclusive[..., 1:], torch.zeros_like(v[..., :1])], dim=-1)


def ssd_tc_decays(dt, A, *, chunk):
    """The decays of the tensor-core kernel, in f32 (f64 for f64 inputs),
    from sums of dt·A that are never a difference: per 16-step tile each
    step's inclusive prefix pre_i and exclusive suffix suf_j, the tile sums
    tot_K, and

    * ``decay`` (b,h,nc,c,c): exp(seg_ij)·dt_j for i ≥ j, 0 above — below
      the diagonal tiles the product (exp(pre_i)·exp(tot_{J+1} + … +
      tot_{I-1}))·(exp(suf_j)·dt_j), in the diagonal 16 × 16 tiles exp of
      the sum down each column;
    * ``erow`` (b,h,nc,c): exp(cum_i), cum_i = (tot_0 + … + tot_{I-1}) + pre_i;
    * ``coef`` (b,h,nc,c): exp(suf_j + (tot_{J+1} + … + tot_{nt-1}))·dt_j;
    * ``total`` (b,h,nc): exp(tot_0 + … + tot_{nt-1})."""
    b, h, l = dt.shape
    if chunk % 16 or l % chunk:
        raise ValueError(f"ssd_tc_decays: chunk {chunk} must be a multiple of 16 dividing {l}")
    nc, nt = l // chunk, chunk // 16
    ct = torch.promote_types(dt.dtype, torch.float32)
    dt_t = dt.to(ct).reshape(b, h, nc, nt, 16)
    la = dt_t * A.to(ct)[None, :, None, None, None]
    pre = torch.cumsum(la, dim=-1)
    suf = _exclusive_suffix(la)
    tot = pre[..., -1]  # (b,h,nc,nt)
    before = torch.cat([torch.zeros_like(tot[..., :1]), torch.cumsum(tot, dim=-1)[..., :-1]], -1)
    after = _exclusive_suffix(tot)
    erow = torch.exp(before[..., None] + pre)
    coef = torch.exp(suf + after[..., None]) * dt_t
    total = torch.exp(torch.sum(tot, dim=-1))

    K = torch.arange(nt, device=dt.device)
    # between[J, I] = Σ tot_K over J < K < I
    between_mask = ((K[None, :, None] > K[:, None, None]) & (K[None, :, None] < K[None, None, :]))
    between = torch.einsum("...k,jki->...ji", tot, between_mask.to(ct))
    tilef = torch.where(K[:, None] < K[None, :], torch.exp(between), 0.0)  # (..., J, I)
    rowf = torch.exp(pre)  # (..., I, a)
    colf = torch.exp(suf) * dt_t  # (..., J, b)
    # (b,h,nc, I, a, J, bb): (rowf_i · tilef[J, I]) · colf_j
    off = (rowf[..., :, :, None, None] * tilef.transpose(-1, -2)[..., :, None, :, None]
           ) * colf[..., None, None, :, :]
    # diagonal tiles: exp of the sum down column bb from row bb + 1 to row a
    r = torch.arange(16, device=dt.device)
    below = r[:, None] > r[None, :]  # (a, bb)
    seg = torch.cumsum(torch.where(below, la[..., :, None], 0.0), dim=-2)  # (..., I, a, bb)
    diag = torch.where(r[:, None] >= r[None, :], torch.exp(seg) * dt_t[..., None, :], 0.0)
    eye = (K[:, None] == K[None, :])[:, None, :, None]  # (I, 1, J, 1)
    decay = torch.where(eye, diag[..., :, :, None, :].expand_as(off), off)
    decay = decay.reshape(b, h, nc, chunk, chunk)
    return {"decay": decay, "erow": erow.reshape(b, h, nc, chunk),
            "coef": coef.reshape(b, h, nc, chunk), "total": total}


def _split_bf16(v):
    """v (f32) as its bf16 high half and the bf16 of the rest, both back in
    f32: hi + lo carries ~16 of v's 24 bits."""
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype)


def ssd_scan_tc_ref(x, dt, A, B, C, *, chunk=128):
    """The tensor-core kernel's arithmetic in plain torch, f32: the decays
    of :func:`ssd_tc_decays`; G = C·Bᵀ; the f32 operands M = G ∘ decay, the
    state H and coef ∘ B each split into bf16 high and low halves, each
    product of two halves accumulated in f32 — y = exp(cum)·(C·H_hiᵀ +
    C·H_loᵀ) + M_hi·x + M_lo·x and H ← exp(total)·H + (coef∘B)_hiᵀ·x +
    (coef∘B)_loᵀ·x — and y rounded to x's dtype once."""
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    nc = l // chunk
    f32 = torch.float32
    dec = ssd_tc_decays(dt.to(f32), A.to(f32), chunk=chunk)
    x32 = x.to(f32).reshape(b, h, nc, chunk, dh)
    B32 = B.to(f32).reshape(b, nc, chunk, ds)
    C32 = C.to(f32).reshape(b, nc, chunk, ds)

    G = torch.einsum("bnis,bnjs->bnij", C32, B32)
    M_hi, M_lo = _split_bf16(G[:, None] * dec["decay"])
    y_intra = (torch.einsum("bhnij,bhnjd->bhnid", M_hi, x32)
               + torch.einsum("bhnij,bhnjd->bhnid", M_lo, x32))
    state = torch.zeros((b, h, dh, ds), dtype=f32, device=x.device)
    ys = []
    for n in range(nc):
        H_hi, H_lo = _split_bf16(state)
        inter = (torch.einsum("bis,bhds->bhid", C32[:, n], H_hi)
                 + torch.einsum("bis,bhds->bhid", C32[:, n], H_lo))
        ys.append(dec["erow"][:, :, n, :, None] * inter + y_intra[:, :, n])
        Bc_hi, Bc_lo = _split_bf16(B32[:, None, n] * dec["coef"][:, :, n, :, None])
        chunk_state = (torch.einsum("bhcd,bhcs->bhds", x32[:, :, n], Bc_hi)
                       + torch.einsum("bhcd,bhcs->bhds", x32[:, :, n], Bc_lo))
        state = dec["total"][:, :, n, None, None] * state + chunk_state
    return torch.stack(ys, dim=2).reshape(b, h, l, dh).to(x.dtype)
