from .engine import make_adamw, param_count, set_lr_scale, set_seed
from .schedulers import ReduceLROnPlateau, warmup_scale
