"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

| kernel | replaces (TPU) | source | wrapper |
| K1 flash_text_fwd | flipped_tpu/model/pallas/flash_attention.py:59 | csrc/flash_text_fwd.cu | flash_attention.flash_text_attention |
| K2 flash_text_bwd | flipped_tpu/model/pallas/flash_attention.py:174 | csrc/flash_text_bwd.cu | flash_attention.flash_text_attention_bwd |
| K5 flash_stream_fwd | flipped_tpu/model/pallas/flash_attention.py:314 | csrc/flash_stream_fwd.cu | flash_attention.flash_streaming_fwd |
| K6a flash_stream_dq | flipped_tpu/model/pallas/flash_attention.py:484 | csrc/flash_stream_bwd.cu | flash_attention.flash_streaming_dq |
| K6b flash_stream_dkv | flipped_tpu/model/pallas/flash_attention.py:535 | csrc/flash_stream_bwd.cu | flash_attention.flash_streaming_dkv |
| K3 int8_fwd | flipped_tpu/model/pallas/quant_matmul.py:603 | csrc/int8_fwd.cu | quant_matmul.int8_fwd |
| K3 int8_decode (x of at most 64 rows) | flipped_tpu/model/pallas/quant_matmul.py:603 | csrc/int8_decode.cu | quant_matmul.int8_fwd |
| K7 int8_grouped_fwd | flipped_tpu/model/pallas/quant_matmul.py:55 | csrc/int8_grouped_fwd.cu | quant_matmul.grouped_matmul |
| K7 int8_grouped_decode (x of at most 64 rows) | flipped_tpu/model/pallas/quant_matmul.py:55 | csrc/int8_decode.cu | quant_matmul.grouped_matmul |
| K4 quant_dx | flipped_tpu/model/pallas/quant_matmul.py:316 | csrc/quant_dx.cu | quant_matmul.quant_dx |
| K8 int4_fwd | flipped_tpu/model/pallas/quant_matmul.py:160 | csrc/int4_fwd.cu | quant_matmul.int4_matmul |
| K8 int4_decode (x of at most 64 rows) | flipped_tpu/model/pallas/quant_matmul.py:160 | csrc/int4_decode.cu | quant_matmul.int4_matmul |
| K9 int4_dx | flipped_tpu/model/pallas/quant_matmul.py:701 | csrc/int4_dx.cu | quant_matmul.int4_dx |
| K10 int8_dgrad | flipped_tpu/model/pallas/quant_matmul.py:449 | csrc/int8_dgrad.cu | quant_matmul.int8_dgrad |

`build.build()` compiles csrc/ at first use; nothing here imports a
compiler or touches the card when the module is imported.
"""
