"""The expansion epilogue (``mid_pool_kernel``): the output projection
per mode, its LayerNorm, the mode scores and the softmax pool over modes.

``mid`` tier (``fused_mid_output_pool``, ``..._permode``): from the
attention probabilities P [B, M, N, A] and V W1 [B, M, A, F]: mid =
gelu(P (V W1) + b1), then the rest. ``private`` tier
(``fused_private_output_pool``): from mid [B, M, N, F].
"""


def work(kind: str, b: int, m: int, n: int, a: int, f: int,
         act_bytes: int = 2, param_bytes: int = 2):
    """(FLOP, bytes) of one call: the matrix products (P (V W1) and the
    [F, F] projection per mode), each input read once (activations in the
    compute dtype, parameters as the kernel takes them) and the pooled
    [B, N, F] output written once."""
    flops = 2 * b * m * n * f * (f if kind == "private" else a + f)
    params = m * f * f + m * f + 3 * f + 1            # W2, b2, LN, ws, bs
    if kind == "private":
        acts = b * m * n * f
    else:
        acts = b * m * n * a + b * m * a * f
        params += f                                   # b1
    nbytes = acts * act_bytes + params * param_bytes + b * n * f * act_bytes
    return flops, nbytes
