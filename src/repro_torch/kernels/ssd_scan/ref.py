"""Plain PyTorch versions of the SSD scan — the counterparts of
``repro.kernels.ssd_scan.ref``:

``ssd_scan_ref``         the step-by-step recurrence (the ground truth);
``ssd_scan_chunked_ref`` the chunked reformulation, the kernel's arithmetic
                         in plain torch; the kernel's wrapper runs it on CPU
                         tensors.  Both take the decay between steps j and i
                         from a direct sum of dt·A over (j, i], where the
                         reference takes a difference of cumulative sums.
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
