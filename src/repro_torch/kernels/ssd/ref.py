"""Plain PyTorch version of the SSD scan kernel: the port of the JAX
package's `models/ssm.py::ssd_chunked` (the Mamba2 chunked state-space-dual
scan) and of `kernels/ssd/ref.py::ssd_ref`.  It lives beside the kernel, not
in `models/ssm.py`, so that `models/ssm.py -> kernels/ssd/ops.py -> ref.py`
is not an import cycle."""
from __future__ import annotations

import torch


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
    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B_.float().reshape(b, nc, chunk, n)
    Cc = C_.float().reshape(b, nc, chunk, n)

    dA = dtc * A.float()                                     # (b,nc,l,h) <= 0
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
    (b,s,n).  All cast to f32.  Returns (y (b,s,h,p), h_final (b,h,p,n))."""
    return ssd_chunked(x.float(), dt.float(), A.float(), B_.float(),
                       C_.float(), chunk)
