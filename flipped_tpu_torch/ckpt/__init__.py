from .convert import (flatten_flax, flax_path_to_torch_name, needs_transpose,
                      params_from_flax)
from .quantize import (dequantize_kernel, outlier_count, quantize_frozen,
                       quantize_kernel, randomize_quantized)

__all__ = ["flatten_flax", "flax_path_to_torch_name", "needs_transpose",
           "params_from_flax", "dequantize_kernel", "outlier_count",
           "quantize_frozen", "quantize_kernel", "randomize_quantized"]
