from .engine import (
    EpochDriver,
    aggregate_runs,
    l1_l2_regularizer,
    make_adamw,
    param_count,
    resolve_device,
    set_lr_scale,
    set_seed,
    synchronize,
)
from .schedulers import ReduceLROnPlateau, warmup_scale
