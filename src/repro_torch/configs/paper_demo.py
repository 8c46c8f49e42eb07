"""paper-demo — the ~88M-parameter llama-style decoder (GQA 12/4 heads,
head_dim 64, RoPE, SwiGLU, tied embeddings) that the port serves end to
end; same dimensions as the reference package's ``paper_demo``.
"""
from repro_torch.models.common import DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paper-demo", family=DENSE,
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=16384, tied_embeddings=True,
        rope_theta=10000.0, remat="none", head_pad_to=1, vocab_pad_to=1,
    )
