"""Offline feature extraction of the port: the numpy log-mel pipeline and
the video/audio extractors (JAX: flipped_tpu/preprocess)."""
from .mel import (chunk_and_stack, hz_to_mel, log_mel_spectrogram,
                  mel_filterbank, mel_to_hz, three_crop_mel)

__all__ = ["chunk_and_stack", "hz_to_mel", "log_mel_spectrogram",
           "mel_filterbank", "mel_to_hz", "three_crop_mel"]
