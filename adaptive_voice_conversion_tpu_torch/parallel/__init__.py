from .scaling import scaling_sweep
from .tp import gather_params_tp, make_tp_train_step, shard_params_tp, tp_param_specs

__all__ = [
    "scaling_sweep",
    "gather_params_tp",
    "make_tp_train_step",
    "shard_params_tp",
    "tp_param_specs",
]
