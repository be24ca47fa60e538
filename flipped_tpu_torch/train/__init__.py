from .builder import (build_eval_state, build_model, build_train_state,
                      check_dtype_policy, init_params, resolve_model_config)
from .generation import (MAX_NEW_TOKENS, decode_generated,
                         make_generation_step, pool_option_embeddings)
from .objectives import (Losses, ce_ignore_index, compute_objective_losses,
                         fused_forward, option_scores, option_scores_cached,
                         token_ce_unreduced)
from .optim import (TRAINABLE_MARKERS, Optimizer, wd_mask, is_trainable,
                    lr_schedule, make_optimizer, trainable_parameters)
from .step import (TrainMetrics, bucket_span, make_eval_step, make_train_step,
                   required_eval_span)

__all__ = [
    "build_eval_state", "build_model", "build_train_state",
    "check_dtype_policy", "init_params", "resolve_model_config",
    "MAX_NEW_TOKENS", "decode_generated", "make_generation_step",
    "pool_option_embeddings", "Losses",
    "ce_ignore_index", "compute_objective_losses", "fused_forward",
    "option_scores", "option_scores_cached", "token_ce_unreduced",
    "TRAINABLE_MARKERS", "Optimizer", "wd_mask", "is_trainable",
    "lr_schedule", "make_optimizer", "trainable_parameters", "TrainMetrics",
    "bucket_span", "make_eval_step", "make_train_step", "required_eval_span",
]
