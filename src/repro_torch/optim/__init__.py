from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, PartialUpdateError, TrainState, adamw_init, adamw_update,
    clip_by_global_norm, lr_schedule,
)
