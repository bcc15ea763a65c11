"""The squeezed cross-attention forward (``fwd_kernel`` +
``fwd_merge_kernel``): softmax(Q K^T / sqrt(D)) V over G independent
groups of Q [G, Q, D], K [G, N, D], V [G, N, F]."""


def work(g: int, q: int, n: int, d: int, f: int, elem_bytes: int = 2):
    """(FLOP, bytes) of one call: the two products (Q K^T and P V), Q, K
    and V read once and the [G, Q, F] output written once."""
    flops = 2 * g * q * n * (d + f)
    nbytes = (g * q * d + g * n * d + g * n * f + g * q * f) * elem_bytes
    return flops, nbytes
