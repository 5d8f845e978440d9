"""Plain torch versions of the SSD intra-chunk kernel (``csrc/ssd.cu``) and
of the inter-chunk recurrence (``csrc/ssd_state.cu``)."""

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
    x = x.float()
    da_cs = da_cs.float()
    bex = b_mat.float().repeat_interleave(rep, dim=2)         # (BC,L,H,N)
    cex = c_mat.float().repeat_interleave(rep, dim=2)

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
