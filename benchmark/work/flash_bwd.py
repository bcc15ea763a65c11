"""The squeezed cross-attention's flash backward (``dkdv_kernel``, then
``dq_kernel`` and ``dq_sum_kernel``): from Q [G, Q, D], K [G, N, D],
V [G, N, F], dO [G, Q, F] and the forward's row statistics (lse, delta
[G, Q, 1] in float32), the gradients dK, dV and dQ."""


def work(g: int, q: int, n: int, d: int, f: int, elem_bytes: int = 2):
    """(FLOP, bytes) of one backward: dK/dV recomputes S = Q K^T and forms
    dP = dO V^T, dV = P^T dO and dK = dS^T Q, 2GQN(2D + 2F); dQ recomputes
    S and forms dP and dQ = dS K, 2GQN(2D + F). Q, K, V, dO, lse and delta
    read once, dK, dV and dQ written once."""
    flops = 2 * g * q * n * (2 * d + 2 * f) + 2 * g * q * n * (2 * d + f)
    elems = (g * q * d + g * n * d + g * n * f + g * q * f     # Q K V dO
             + g * n * d + g * n * f + g * q * d)              # dK dV dQ
    nbytes = elems * elem_bytes + 2 * g * q * 4                 # lse, delta
    return flops, nbytes
