"""Plain PyTorch oracle for the Mamba2 SSD chunked scan.

Math (arXiv:2405.21060, SSD): per head h with scalar decay ``a_h < 0``:

    state_t = exp(a_h * dt_t) * state_{t-1} + dt_t * B_t x_t^T
    y_t     = C_t . state_t

computed chunk-parallel: intra-chunk via the (L, L) decay-masked quadratic
form, inter-chunk via a sequential carry over per-chunk states.  The CPU path
of ``ops.ssd_scan`` runs this; on the card it is the CUDA kernel's yardstick.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_ref(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H) float32
    a: torch.Tensor,      # (H,) float32, negative
    bmat: torch.Tensor,   # (B, S, G, N)
    cmat: torch.Tensor,   # (B, S, G, N)
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,S,H,P) float32, final_state: (B,H,P,N) float32)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    L = min(chunk, s)
    if s % L:
        pad = L - s % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    spad = x.shape[1]
    nc = spad // L
    rep = h // g
    # (B,S,H,N): head h reads group h // rep.  Expanded, not repeat_interleave'd:
    # the backward then sums over the heads by a reduction, not by atomic adds,
    # so the recomputed gradient on the card is the same bits every run
    bh = bmat[:, :, :, None, :].expand(b, spad, g, rep, n).reshape(b, spad, h, n)
    ch = cmat[:, :, :, None, :].expand(b, spad, g, rep, n).reshape(b, spad, h, n)

    f32 = torch.float32
    dtf = dt.to(f32)
    da = dtf * a.to(f32)[None, None, :]                     # (B,S,H)
    dtx = dtf[..., None] * x.to(f32)                        # (B,S,H,P)

    # chunked views
    cum = da.reshape(b, nc, L, h).cumsum(dim=2)             # inclusive
    dtx_c = dtx.reshape(b, nc, L, h, p)
    b_c = bh.reshape(b, nc, L, h, n).to(f32)
    c_c = ch.reshape(b, nc, L, h, n).to(f32)

    # ---- intra-chunk quadratic form
    scores = torch.einsum("bclhn,bcshn->bchls", c_c, b_c)   # (B,nc,H,L,L)
    cum_h = cum.permute(0, 1, 3, 2)                         # (B,nc,H,L)
    decay = cum_h[..., :, None] - cum_h[..., None, :]       # cum_l - cum_s
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the upper-triangle decay is positive and exp overflows
    w = decay.masked_fill(~mask, -1e30).exp()
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores * w, dtx_c)

    # ---- per-chunk states and sequential carry
    last = cum[:, :, -1:, :]                                # (B,nc,1,H)
    persist = (last - cum).exp()                            # (B,nc,L,H)
    chunk_states = torch.einsum("bclh,bclhp,bclhn->bchpn", persist, dtx_c, b_c)
    chunk_decay = last[:, :, 0, :].exp()                    # (B,nc,H)

    state = (
        initial_state.to(f32)
        if initial_state is not None
        else torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    )
    entering = []                                           # state ENTERING each chunk
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    entering = torch.stack(entering, dim=1)                 # (B,nc,H,P,N)

    # ---- inter-chunk contribution
    y_inter = torch.einsum("bclh,bclhn,bchpn->bclhp", cum.exp(), c_c, entering)

    y = (y_intra + y_inter).reshape(b, spad, h, p)[:, :s]
    return y, state


def ssd_reference_sequential(x, dt, a, bmat, cmat, initial_state=None):
    """O(S) sequential oracle-of-the-oracle (tests only; tiny shapes)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    f32 = torch.float32
    bh = bmat.repeat_interleave(rep, dim=2).to(f32)
    ch = cmat.repeat_interleave(rep, dim=2).to(f32)
    dtf = dt.to(f32)
    state = (
        initial_state.to(f32)
        if initial_state is not None
        else torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    )
    ys = []
    for t in range(s):
        decay = torch.exp(a.to(f32)[None, :] * dtf[:, t])              # (B,H)
        dx = dtf[:, t, :, None] * x[:, t].to(f32)                      # (B,H,P)
        state = state * decay[..., None, None] + dx[..., None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1), state
