"""Command-line tools of the port: the quantization parity study, the trace
analyzer, the synthetic tokenizer writer and the sweep runner (JAX:
scripts/)."""
