"""AdamW and its cosine schedule.  Port of ``repro.optim``."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr"]
