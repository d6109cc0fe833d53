"""Plain PyTorch versions of the SSD scan kernels: the port of the JAX
package's `models/ssm.py::ssd_chunked` (the Mamba2 chunked state-space-dual
scan) and of `kernels/ssd/ref.py::ssd_ref`, and `ssd_bwd_ref`, the scan's
VJP written out chunk by chunk in the decomposition the backward kernel
uses.  They live beside the kernels, not in `models/ssm.py`, so that
`models/ssm.py -> kernels/ssd/ops.py -> ref.py` is not an import cycle.

They compute in f32, or in f64 when given f64 inputs (the card's checks
hold the kernels against float64 autograd of `ssd_ref`)."""
from __future__ import annotations

import torch


def _f(t):
    """t in f32, or in f64 if it is f64."""
    return t if t.dtype == torch.float64 else t.float()


def _segsum(dA):
    """dA: (..., L) -> (..., L, L) lower-tri S[i,j] = sum_{k=j+1..i} dA[k]
    (-inf above the diagonal)."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    S = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return S.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """Minimal SSD (Mamba2) over chunks, in f32.

    x: (b,s,h,p), dt: (b,s,h) (softplus applied), A: (h,) negative,
    B_, C_: (b,s,n) shared across heads (n_groups=1).  When s % chunk != 0
    the whole sequence is one chunk.  Returns (y (b,s,h,p), h_final
    (b,h,p,n)).  JAX's version also takes bf16 operands; nothing in the
    port calls it so (`mamba2_forward` casts to f32 first), nor with an
    initial state `h0`."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    xc = _f(x).reshape(b, nc, chunk, h, p)
    dtc = _f(dt).reshape(b, nc, chunk, h)
    Bc = _f(B_).reshape(b, nc, chunk, n)
    Cc = _f(C_).reshape(b, nc, chunk, n)

    dA = dtc * _f(A)                                     # (b,nc,l,h) <= 0
    dA_cs = torch.cumsum(dA, dim=2)                          # inclusive

    # intra-chunk
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # (b,nc,h,l,l)
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    Y_diag = torch.einsum("bclm,bchlm,bcmhp->bclhp", CB, L,
                          xc * dtc[..., None])

    # chunk-final states
    decay = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)           # (b,nc,l,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay * dtc, xc)

    # inter-chunk recurrence, with each chunk's off-diagonal term
    chunk_decay = torch.exp(dA.sum(dim=2))                   # (b,nc,h)
    eA = torch.exp(dA_cs)                                    # (b,nc,l,h)
    hprev = xc.new_zeros((b, h, p, n))
    y_offs = []
    for c in range(nc):
        y_offs.append(torch.einsum("bln,blh,bhpn->blhp", Cc[:, c], eA[:, c],
                                   hprev))
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    Y_off = torch.stack(y_offs, dim=1)                       # (b,nc,l,h,p)
    return (Y_diag + Y_off).reshape(b, s, h, p), hprev


def ssd_ref(x, dt, A, B_, C_, chunk: int = 64):
    """x: (b,s,h,p); dt: (b,s,h) softplus'd; A: (h,) negative; B_, C_:
    (b,s,n).  All cast to f32 (f64 stays f64).  Returns (y (b,s,h,p),
    h_final (b,h,p,n))."""
    return ssd_chunked(_f(x), _f(dt), _f(A), _f(B_), _f(C_), chunk)


def _pad_tiles(t, s_pad):
    """t (b, s, ...) with s_pad zero rows appended on the token axis."""
    if s_pad == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], s_pad) + t.shape[2:])], 1)


def ssd_bwd_ref(x, dt, A, B_, C_, dy, dh_final=None, chunk: int = 64):
    """The VJP of `ssd_chunked` in closed form: the gradients (dx (b,s,h,p),
    ddt (b,s,h), dA (h,), dB (b,s,n), dC (b,s,n)) of <dy, y> + <dh_final,
    h_final>, in f32 (f64 for f64 inputs).  dA is summed over b and s, dB
    and dC over the heads (B and C are shared).  dh_final None means 0.

    Chunks of `chunk` tokens; a ragged tail is padded with dt = 0 and zero
    x, B, C and dy, which leaves cs flat and adds nothing, so the result
    does not depend on the chunking beyond rounding (the forward takes a
    ragged s as one chunk).  Per chunk c, with cs the inclusive cumsum of
    dA = dt A inside it, E_ij = exp(cs_i - cs_j) (j <= i) and
    w_j = exp(cs_L - cs_j) dt_j:
      H_c   = exp(cs_L) H_{c-1} + sum_j w_j x_j B_j^T        (recomputed)
      G_c   = dL/dH_c:  G_{c-1} = exp(cs_L) G_c + sum_t exp(cs_t) dy_t C_t^T,
              G_last = dh_final                    (reverse state passing)
      M_ij  = (C_i . B_j) E_ij dt_j,  dM_ij = dy_i . x_j
      dx_j  = sum_i M_ij dy_i + w_j G_c B_j
      dC_i  = sum_j dCB_ij B_j + exp(cs_i) H_{c-1}^T dy_i,  dCB = dM E dt_j
      dB_j  = sum_i dCB_ij C_i + w_j G_c^T x_j
    and the log-decay gradient dcs (from M, from exp(cs_i) in y's
    carried-state term, from w and from the state's decay exp(cs_L)) turns
    into ddA by a reverse cumsum inside the chunk: ddt += A ddA,
    dA = sum dt ddA."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    L = chunk
    nc = -(-s // L)
    pad = nc * L - s
    xc = _pad_tiles(_f(x), pad).reshape(b, nc, L, h, p)
    dtc = _pad_tiles(_f(dt), pad).reshape(b, nc, L, h)
    Bc = _pad_tiles(_f(B_), pad).reshape(b, nc, L, n)
    Cc = _pad_tiles(_f(C_), pad).reshape(b, nc, L, n)
    dyc = _pad_tiles(_f(dy), pad).reshape(b, nc, L, h, p)
    A = _f(A)

    cs = torch.cumsum(dtc * A, dim=2)                        # (b,nc,L,h)
    csL = cs[:, :, -1]                                       # (b,nc,h)
    decay = torch.exp(csL)
    ecs = torch.exp(cs)
    w = torch.exp(csL[:, :, None] - cs) * dtc                # (b,nc,L,h)

    # the state entering each chunk, recomputed
    states = torch.einsum("bclh,bclhp,bcln->bchpn", w, xc, Bc)
    hin, hc = [], xc.new_zeros((b, h, p, n))
    for c in range(nc):
        hin.append(hc)
        hc = hc * decay[:, c, :, None, None] + states[:, c]
    hin = torch.stack(hin, 1)                                # (b,nc,h,p,n)

    # reverse state passing: G_c, the gradient of the state leaving chunk c
    carry = torch.einsum("bclh,bclhp,bcln->bchpn", ecs, dyc, Cc)
    gc = xc.new_zeros((b, h, p, n)) if dh_final is None else _f(dh_final)
    gout = [None] * nc
    for c in reversed(range(nc)):
        gout[c] = gc
        gc = gc * decay[:, c, :, None, None] + carry[:, c]
    gout = torch.stack(gout, 1)                              # (b,nc,h,p,n)

    # intra-chunk terms through exp(segsum)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]        # (b,nc,i,j,h)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    E = torch.exp(seg.masked_fill(~causal, float("-inf")))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]  # (b,nc,i,j,1)
    dM = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    dtj = dtc[:, :, None]                                    # (b,nc,1,j,h)
    M = CB * E * dtj
    T = dM * CB * E                       # dM_ij * dM_ij/d(dt_j)
    dCB = (dM * E * dtj).sum(-1)          # summed over the heads

    # chunk-state terms exp(cs_L - cs_j) G_c B_j
    GB = torch.einsum("bchpn,bcjn->bcjhp", gout, Bc)
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dyc) + w[..., None] * GB
    doff = ecs[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc, hin)
    dC = torch.einsum("bcij,bcjn->bcin", dCB, Bc) + doff.sum(3)
    dB = torch.einsum("bcij,bcin->bcjn", dCB, Cc) \
        + torch.einsum("bcjh,bcjhp,bchpn->bcjn", w, xc, gout)

    # the log-decay gradient
    dw = (xc * GB).sum(-1)                                   # (b,nc,L,h)
    dcs = (T * dtj).sum(3) - dtc * T.sum(2) \
        + torch.einsum("bcihn,bcin->bcih", doff, Cc) - w * dw
    dcs[:, :, -1] += decay * (gout * hin).sum((-1, -2)) + (w * dw).sum(2)
    ddA = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])
    ddt = T.sum(2) + torch.exp(csL[:, :, None] - cs) * dw + A * ddA
    dA = (dtc * ddA).sum((0, 1, 2))

    def unpad(t):
        return t.reshape((b, nc * L) + t.shape[3:])[:, :s]

    return unpad(dx), unpad(ddt), dA, unpad(dB), unpad(dC)
