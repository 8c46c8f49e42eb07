"""mamba2-370m [ssm] — attention-free SSD stack; same dimensions as the
reference package's ``mamba2_370m``.

48L d_model=1024 vocab=50280 ssm_state=128, d_ff=0 (no MLP blocks)
[arXiv:2405.21060; unverified]. headdim=64 → 32 SSD heads.
"""
from repro_torch.models.common import SSM, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family=SSM,
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=1, d_ff=0,
        vocab_size=50280, tied_embeddings=True, rope_theta=0.0,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      n_groups=1, chunk_size=64),
    )
