"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention;
same dimensions as the reference package's ``h2o_danube3_4b``.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000
[arXiv:2401.16818; unverified]. Window = 4096 (danube SWA recipe;
documented assumption, DESIGN.md §4). SWA makes long_500k decode runnable:
the KV cache is a window-bounded ring buffer.
"""
from repro_torch.models.common import DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family=DENSE,
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab_size=32000, window=4096,
        tied_embeddings=False, rope_theta=10000.0,
    )
