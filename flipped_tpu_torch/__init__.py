"""flipped_tpu_torch — the PyTorch and CUDA port of flipped_tpu for NVIDIA Hopper.

The JAX package `flipped_tpu` stays beside this one as the reference; each
module here names its JAX counterpart. This package imports `torch` and
nothing of the JAX package: the numpy host layers it needs (`text/`,
`data/`, `log_qtype`) are its own copies, which the tests hold equal to
the originals, so both packages see identical batches.

Layer map (mirrors flipped_tpu):
  core/           config dataclasses and the CLI parser
  text/           tokenizers, prompt encoders, label masking (copies)
  data/           dataset readers, loader, batching (copies), fixture writer
  model/          adapter-gated LLaMA as nn.Modules, plain attention math
  model/kernels/  hand-written CUDA kernels: build, bind, plain twins,
                  the autograd.Function around K1 and K2
  csrc/           CUDA C++ sources (sm_90a), built at first use
  ckpt/           Flax-tree → reference state_dict conversion
  train/          objectives, train and eval steps, AdamW, builder
  utils/          a minimal metric logger and the qtype buckets
  cli/            the train, evaluate and profile entry points
"""

__version__ = "0.1.0"
