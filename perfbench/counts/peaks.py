"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no
sparsity; at the full 700 W power limit)."""
HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, flops: float, dtype: str) -> float:
    """The least time the card can take: the larger of the bytes at the
    memory's rate and the operations at the type's peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FLOPS[dtype])
