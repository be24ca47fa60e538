from .convert import (export_meta_checkpoint, flatten_flax,
                      flax_path_to_torch_name, load_meta_checkpoint,
                      merge_shards, needs_transpose, params_from_flax,
                      split_dim_table)
from .manager import CheckpointManager
from .quantize import (dequantize_kernel, outlier_count, quantize_frozen,
                       quantize_kernel, randomize_quantized)
from .rotate import Rotation, fwht_, rotate_params

__all__ = ["export_meta_checkpoint", "flatten_flax", "flax_path_to_torch_name",
           "load_meta_checkpoint", "merge_shards", "needs_transpose",
           "params_from_flax", "split_dim_table", "CheckpointManager",
           "dequantize_kernel", "outlier_count", "quantize_frozen",
           "quantize_kernel", "randomize_quantized", "Rotation", "fwht_",
           "rotate_params"]
