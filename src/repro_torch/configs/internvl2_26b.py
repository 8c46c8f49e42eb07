"""internvl2-26b [vlm] — InternLM2-20b decoder backbone, InternViT stubbed;
same dimensions as the reference package's ``internvl2_26b``.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]. The inputs carry ``n_patches=1024`` precomputed
patch embeddings of width ``frontend_dim``, projected and prepended to the
token sequence. Full attention.
"""
from repro_torch.models.common import VLM, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family=VLM,
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553, tied_embeddings=False,
        rope_theta=1000000.0,
        frontend_dim=3200, n_patches=1024,
    )
