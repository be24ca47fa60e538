"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

| kernel | replaces (TPU) | source |
| K1 flash_text_fwd | flipped_tpu/model/pallas/flash_attention.py:59 | csrc/flash_text_fwd.cu |

`build.build()` compiles csrc/ at first use; nothing here imports a
compiler or touches the card when the module is imported.
"""
