from .builder import (build_eval_state, build_model, check_dtype_policy,
                      init_params, resolve_model_config)
from .objectives import (ce_ignore_index, option_scores, option_scores_cached,
                         token_ce_unreduced)
from .optim import TRAINABLE_MARKERS, is_trainable
from .step import bucket_span, make_eval_step, required_eval_span

__all__ = [
    "build_eval_state", "build_model", "check_dtype_policy", "init_params",
    "resolve_model_config", "ce_ignore_index", "option_scores",
    "option_scores_cached", "token_ce_unreduced", "TRAINABLE_MARKERS",
    "is_trainable", "bucket_span", "make_eval_step", "required_eval_span",
]
