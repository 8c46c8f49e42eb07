"""PyTorch / CUDA port of the continuation-driven serving system.

The reference is the JAX package ``repro``; this package mirrors its layout
(``repro_torch.core`` ↔ ``repro.core`` and so on) and imports nothing of
it. Entry points (``serve.ServeEngine``, ``serve.greedy_generate``,
``models.lm.init_params``) run on the GPU unless the caller passes
``device="cpu"``.
"""
