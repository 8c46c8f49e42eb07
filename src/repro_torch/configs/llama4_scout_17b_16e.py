"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert; same
dimensions as the reference package's ``llama4_scout_17b_16e``.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. 40 heads pad to 48
(8 groups of 5 real + 1 zero-weight slot). iRoPE chunked attention is not
modeled (full attention), as in the reference → long_500k skip.
"""
from repro_torch.models.common import MOE, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family=MOE,
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048, tied_embeddings=False,
        rope_theta=500000.0,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, shared_d_ff=8192,
                      capacity_factor=1.25, dispatch="einsum"),
    )
