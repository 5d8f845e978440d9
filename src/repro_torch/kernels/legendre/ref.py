"""Plain torch version of the Legendre contraction kernel."""

import torch


def legendre_contract_ref(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[b, n, m] = sum_k x[b, k, m] * table[k, n, m].

    A complex64 x contracts its real and imaginary parts with the same
    real table; any other x is computed in float32.
    """
    if x.is_complex():
        return torch.complex(legendre_contract_ref(x.real, table),
                             legendre_contract_ref(x.imag, table))
    return torch.einsum("bkm,knm->bnm", x.float(), table.float())
