"""whisper-large-v3 [audio] — enc-dec backbone, conv frontend stubbed; same
dimensions as the reference package's ``whisper_large_v3``.

32L (32 enc + 32 dec) d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified]. 20 heads pad to 32 (12 zero-weight q, k,
v and o slots). The inputs are precomputed frame embeddings of width
``frontend_dim`` (the two conv+GELU stem layers are the stub). Sinusoidal
encoder and decoder positions, no RoPE. Runs through ``models.encdec``.
"""
from repro_torch.models.common import AUDIO, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family=AUDIO,
        n_layers=32, n_enc_layers=32, n_dec_layers=32,
        d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab_size=51866, tied_embeddings=True,
        rope_theta=0.0,  # sinusoidal/learned positions, not RoPE
        frontend_dim=1280, max_target_len=448,
    )
