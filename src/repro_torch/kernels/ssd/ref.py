"""Plain torch versions of the SSD intra-chunk kernel (``csrc/ssd.cu``), of
the inter-chunk recurrence (``csrc/ssd_state.cu``) and of their backward
kernels (``csrc/ssd_bwd.cu``, ``csrc/ssd_state_bwd.cu``)."""

import torch


def ssd_intra_chunk_ref(x: torch.Tensor, da_cs: torch.Tensor,
                        b_mat: torch.Tensor, c_mat: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shapes as in ``repro_torch.kernels.ssd.ops.ssd_intra_chunk``.

    The lower-triangular mask is applied before ``exp`` (masked entries
    become ``-inf``, whose ``exp`` is 0): above the diagonal ``cs_l -
    cs_s`` is positive and may overflow.
    """
    bc, l, h, p = x.shape
    g = b_mat.shape[2]
    rep = h // g
    # float32, or float64 where the caller asks for it (a yardstick of the
    # kernels' own rounding)
    dt = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dt)
    da_cs = da_cs.to(dt)
    bex = b_mat.to(dt).repeat_interleave(rep, dim=2)          # (BC,L,H,N)
    cex = c_mat.to(dt).repeat_interleave(rep, dim=2)

    diff = da_cs[:, :, None, :] - da_cs[:, None, :, :]       # (BC,L,L,H)
    tri = torch.ones((l, l), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    decay = diff.masked_fill(~tri, float("-inf")).exp()
    cb = torch.einsum("blhn,bshn->blsh", cex, bex)
    att = cb * decay
    y = torch.einsum("blsh,bshp->blhp", att, x)

    decay_states = torch.exp(da_cs[:, -1:, :] - da_cs)        # (BC,L,H)
    states = torch.einsum("blhn,blh,blhp->bhpn", bex, decay_states, x)
    return y, states


def chunk_recurrence_ref(states: torch.Tensor, chunk_decay: torch.Tensor,
                         init: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk scan, a plain loop over the chunks (two launches a
    chunk on a card).

    states: (B, nc, H, P, N) each chunk's own end state; chunk_decay:
    (B, nc, H) exp of each chunk's dA sum; init: (B, H, P, N).  Returns
    (the state entering each chunk (B, nc, H, P, N), the final state).
    """
    decay = chunk_decay[..., None, None]
    prev = torch.empty_like(states)
    carry = init
    for i in range(states.shape[1]):
        prev[:, i] = carry
        carry = torch.addcmul(states[:, i], carry, decay[:, i])
    return prev, carry


def ssd_intra_chunk_bwd_ref(x: torch.Tensor, da_cs: torch.Tensor,
                            b_mat: torch.Tensor, c_mat: torch.Tensor,
                            dy: torch.Tensor, dstates: torch.Tensor
                            ) -> tuple[torch.Tensor, ...]:
    """The plain version of ``csrc/ssd_bwd.cu``: autograd of
    ``ssd_intra_chunk_ref``, the gradients in (x, da_cs, b_mat, c_mat)
    given dy (BC, L, H, P) and dstates (BC, H, P, N)."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_(True)
               for t in (x, da_cs, b_mat, c_mat)]
        y, st = ssd_intra_chunk_ref(*ins)
        return torch.autograd.grad((y, st), ins, (dy, dstates))


def chunk_recurrence_bwd_ref(dprev: torch.Tensor, dfinal: torch.Tensor,
                             prev: torch.Tensor, chunk_decay: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The plain version of ``csrc/ssd_state_bwd.cu``: the reverse scan
    over chunks, G = dfinal, then for c = nc - 1 .. 0 dstates[c] = G,
    dchunk_decay[c] = sum G * prev[c], G = decay[c] G + dprev[c]; dinit
    = G.  Returns (dstates, dchunk_decay, dinit), what autograd of
    ``chunk_recurrence_ref`` gives from the entering states ``prev``
    that it returned."""
    decay = chunk_decay[..., None, None]
    dstates = torch.empty_like(prev)
    ddecay = torch.empty_like(chunk_decay)
    g = dfinal
    for c in range(prev.shape[1] - 1, -1, -1):
        dstates[:, c] = g
        ddecay[:, c] = (g * prev[:, c]).sum(dim=(-2, -1))
        g = torch.addcmul(dprev[:, c], g, decay[:, c])
    return dstates, ddecay, g
