"""Plain torch versions of the banded DISCO contraction and its transpose."""

import torch


def disco_band_contract_ref(x_gathered: torch.Tensor, psi_band: torch.Tensor,
                            stride: int = 1) -> torch.Tensor:
    """out[b,k,h,w] = sum_{s,d} psi[k,h,s,d] * x[b,h,s,(w*stride+d) % W].

    x_gathered: (B, H_out, S, W_in); psi_band: (K, H_out, S, D).
    Accumulates one tap d at a time, so no (B, H, S, D, W) window tensor
    is ever materialised (it is 13 GB per plane-batch at 721x1440).
    """
    b, h, s, w_in = x_gathered.shape
    k, _, _, d = psi_band.shape
    w_out = w_in // stride
    xg = x_gathered.float()
    psi = psi_band.float()
    xp = torch.cat([xg, xg[..., :d]], dim=-1)
    out = xg.new_zeros((b, k, h, w_out))
    for dd in range(d):
        win = xp[..., dd:dd + (w_out - 1) * stride + 1:stride]  # (B,H,S,Wo)
        out += torch.einsum("khs,bhsw->bkhw", psi[..., dd], win)
    return out


def disco_gather_band_contract_ref(x: torch.Tensor, psi_band: torch.Tensor,
                                   lat_idx: torch.Tensor,
                                   stride: int = 1) -> torch.Tensor:
    """The function the CUDA kernel computes: roll + gather + band.

    x: (B, H_in, W_in) -> (B, K, H_out, W_in // stride), with
    out[b,k,h,w] = sum_{s,d} psi[k,h,s,d] *
                   x[b, lat_idx[h,s], (w*stride + d + off0) % W_in]
    and off0 = -(D // 2): the roll that puts band tap 0 at offset off0,
    the latitude gather, then ``disco_band_contract_ref``.
    """
    _, h_out, s, d = psi_band.shape
    off0 = -(d // 2)
    xr = torch.roll(x, -off0, dims=-1) if off0 else x
    xg = xr.index_select(-2, lat_idx.reshape(-1).long())
    xg = xg.reshape(x.shape[:-2] + (h_out, s, x.shape[-1]))
    return disco_band_contract_ref(xg, psi_band, stride)


def disco_band_transpose_ref(g: torch.Tensor, psi_band: torch.Tensor,
                             lat_idx: torch.Tensor, h_in: int,
                             stride: int = 1) -> torch.Tensor:
    """The transpose of ``disco_gather_band_contract_ref`` in x: its VJP.

    g: (B, K, H_out, W_out) -> (B, h_in, W_out * stride), with
    gx[b, r, v] = sum over (h, s) with lat_idx[h, s] = r, over k and over
    the taps d with (w*stride + d + off0) % W_in = v of
    psi[k, h, s, d] * g[b, k, h, w].  Scatters one tap at a time into
    the gathered rows, then adds the rows into their latitudes and
    undoes the roll.
    """
    b, k, h_out, w_out = g.shape
    _, _, s, d = psi_band.shape
    w_in = w_out * stride
    gf, psi = g.float(), psi_band.float()
    cols = torch.arange(w_out, device=g.device) * stride
    gxg = gf.new_zeros((b, h_out, s, w_in))
    for dd in range(d):
        tap = torch.einsum("khs,bkhw->bhsw", psi[..., dd], gf)
        gxg.index_add_(-1, (cols + dd) % w_in, tap)
    gxr = gf.new_zeros((b, h_in, w_in))
    gxr.index_add_(1, lat_idx.reshape(-1).long(),
                   gxg.reshape(b, h_out * s, w_in))
    off0 = -(d // 2)
    return torch.roll(gxr, off0, dims=-1) if off0 else gxr
