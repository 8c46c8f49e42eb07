"""AdamW, global-norm clipping, learning-rate schedules and the int8
error-feedback gradient sync of the trainer: the port's copy of
``repro/optim``."""
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     opt_state_specs)
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import (CompressionState,
                                        compressed_psum_mean,
                                        init_compression_state)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["adamw_init", "adamw_update", "opt_state_specs", "OptConfig",
           "warmup_cosine", "constant", "clip_by_global_norm", "global_norm",
           "compressed_psum_mean", "CompressionState",
           "init_compression_state"]
