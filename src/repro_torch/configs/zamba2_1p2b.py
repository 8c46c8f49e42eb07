"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks; same
dimensions as the reference package's ``zamba2_1p2b``.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]. Shared transformer block at width 2·d_model applied
before every 6th SSM layer (7 sites) with per-site output projectors;
LoRA-style per-site adapters on the shared block are omitted, as in the
reference.
"""
from repro_torch.models.common import HYBRID, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family=HYBRID,
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=8192, vocab_size=32000, tied_embeddings=True,
        hybrid_attn_every=6, rope_theta=10000.0,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                      n_groups=1, chunk_size=64),
        scan_layers=False,  # heterogeneous pattern: python-loop layers
    )
