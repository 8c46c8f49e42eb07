"""granite-4.0-h-small [moe_hybrid] — Mamba-2 and NoPE GQA mixers by
layer, each followed by a dropless MoE block; the port's own configuration
(the reference package has no such family).

40L d_model=4096 vocab=100352, tied embeddings, rms eps 1e-5
[hf:ibm-granite/granite-4.0-h-small config.json, model_type
``granitemoehybrid``]. Layers 5, 15, 25 and 35 attend (32 query and 8 KV
heads of 128, no positional embedding, softmax scale
``attention_multiplier`` 1/128); the other 36 are Mamba-2 (128 heads of
64, state 128, one group, conv 4 with a bias, no projection bias). After
every mixer an MoE block: a router over 72 SwiGLU experts of 768, top-10,
gates the softmax of the 10 top logits, and a shared SwiGLU expert of
1536. The embedding is multiplied by 12, each residual branch by 0.22,
the logits divided by 16. 32,207,337,984 parameters, 8.80 B active a
token. ``chunk_size`` 64 is the SSD kernel's chunk (256 published; the
scan's result does not depend on it but for rounding).
"""
from repro_torch.models.common import MoEConfig, MoEHybridConfig, SSMConfig

ATTENTION_LAYERS = (5, 15, 25, 35)


def config() -> MoEHybridConfig:
    return MoEHybridConfig(
        name="granite-4.0-h-small",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=0, vocab_size=100352, norm_eps=1e-5, tied_embeddings=True,
        rope_theta=0.0,   # NoPE
        layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                          for i in range(40)),
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=1.0 / 128, logits_scaling=16.0,
        conv_bias=True,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      n_groups=1, chunk_size=64),
        moe=MoEConfig(n_experts=72, top_k=10, d_ff=768, shared_d_ff=1536,
                      dispatch="dropless"),
        scan_layers=False,  # heterogeneous stack: python-loop layers
    )
