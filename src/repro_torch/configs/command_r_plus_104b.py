"""command-r-plus-104b [dense] — parallel attn+MLP blocks, no-bias, tied;
same dimensions as the reference package's ``command_r_plus_104b``.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified].
"""
from repro_torch.models.common import DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family=DENSE,
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab_size=256000, tied_embeddings=True,
        parallel_block=True, rope_theta=75000000.0,
    )
