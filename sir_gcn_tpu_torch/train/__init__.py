from .engine import (
    EpochDriver,
    aggregate_runs,
    make_adamw,
    param_count,
    resolve_device,
    set_lr_scale,
    set_seed,
    synchronize,
)
from .schedulers import ReduceLROnPlateau, warmup_scale
