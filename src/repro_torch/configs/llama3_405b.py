"""llama3-405b [dense] — GQA, 128k vocab;
same dimensions as the reference package's ``llama3_405b``.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783; unverified]. Full attention → long_500k skip.
"""
from repro_torch.models.common import DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family=DENSE,
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab_size=128256, tied_embeddings=False,
        rope_theta=500000.0,
    )
