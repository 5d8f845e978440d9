"""``gemm_ms.train``: device milliseconds per train step in the dense
matrix products (forward, recomputation and backward), matched by the
kernel names cuBLAS and CUTLASS give them."""

#: substrings of the names of dense-product kernels (lower case)
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "cublas")


def is_gemm(name: str) -> bool:
    """Whether a device operation is a dense matrix product."""
    low = name.lower()
    return any(s in low for s in GEMM_NAMES)


def read(ctx: dict) -> float | None:
    """ms per step, or None where no product ran."""
    n = ctx["work"].get("steps", 0)
    t = ctx["trace"].kernel_s(is_gemm)
    if not n or not t:
        return None
    return 1e3 * t / n
