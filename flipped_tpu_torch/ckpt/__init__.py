from .convert import (flatten_flax, flax_path_to_torch_name, needs_transpose,
                      params_from_flax)

__all__ = ["flatten_flax", "flax_path_to_torch_name", "needs_transpose",
           "params_from_flax"]
