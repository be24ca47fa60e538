from .config import (MODEL_PRESETS, QUANTIZE_CHOICES, DataConfig,
                     ModelConfig, RunConfig, TrainConfig, check_quantize,
                     check_train_ported, get_args_parser, run_config_from_args,
                     validate_audio_flags)

__all__ = [
    "MODEL_PRESETS", "QUANTIZE_CHOICES", "DataConfig", "ModelConfig",
    "RunConfig", "TrainConfig", "check_quantize", "check_train_ported",
    "get_args_parser",
    "run_config_from_args", "validate_audio_flags",
]
