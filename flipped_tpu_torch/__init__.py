"""flipped_tpu_torch — the PyTorch and CUDA port of flipped_tpu for NVIDIA Hopper.

The JAX package `flipped_tpu` stays beside this one as the reference; each
module here names its JAX counterpart. This package imports `torch` and never
`jax`. It reuses the JAX package's numpy-only host layers (`flipped_tpu.text`,
`flipped_tpu.data`) so both packages see identical batches.

Layer map (mirrors flipped_tpu):
  core/           config dataclasses and the evaluate CLI parser
  model/          adapter-gated LLaMA as nn.Modules, plain attention math
  model/kernels/  hand-written CUDA kernels: build, bind, plain twins
  csrc/           CUDA C++ sources (sm_90a), built at first use
  ckpt/           Flax-tree → reference state_dict conversion
  train/          eval objectives, eval step, trainable markers, builder
  utils/          a minimal metric logger
  cli/            the classification-eval entry point
"""

__version__ = "0.1.0"
