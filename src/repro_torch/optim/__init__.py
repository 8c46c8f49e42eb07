"""AdamW, global-norm clipping and learning-rate schedules for the
trainer: the port's copy of ``repro/optim`` (``compress.py``, the int8
error-feedback all-reduce, waits for the sharded trainer; see ROADMAP)."""
from repro_torch.optim.adamw import OptConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["OptConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "constant", "warmup_cosine"]
