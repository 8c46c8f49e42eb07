"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8; same dimensions as the
reference package's ``qwen3_moe_235b_a22b``.

94L d_model=4096 64H (GQA kv=4) head_dim=128 d_ff(expert)=1536
vocab=151936 [hf:Qwen/Qwen3-30B-A3B; hf]. QK-norm is not modeled, as in
the reference. Full attention → long_500k skip.
"""
from repro_torch.models.common import MOE, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family=MOE,
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936, tied_embeddings=False,
        rope_theta=1000000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536,
                      capacity_factor=1.25, dispatch="einsum"),
    )
