"""deepseek-coder-33b [dense] — llama-arch code model;
same dimensions as the reference package's ``deepseek_coder_33b``.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
[arXiv:2401.14196; hf]. 56 heads pad to 64 for 16-way TP (zero-init padded
heads; function preserved — DESIGN.md §5). Full attention → long_500k skip.
"""
from repro_torch.models.common import DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family=DENSE,
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=19200, vocab_size=32256, tied_embeddings=False,
        rope_theta=100000.0,
    )
