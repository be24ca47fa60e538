"""Log-mel fbank pipeline for audio features, pure numpy (JAX:
flipped_tpu/preprocess/mel.py; the port keeps its own copy).

Re-implements the reference's offline audio pipeline (reference:
preprocess/audio_loader.py:35-87): kaldi-style log-mel fbank (25 ms window,
10 ms shift, 128 mel bins, 16 kHz), split into `n_chunks` time chunks,
stacked to 3 channels, and mean/std normalized — producing the
"audio-mel-as-image" tensors the reference feeds to CLIP's image encoder
(preprocess/extract.py:151-186). torchaudio is replaced by a numpy STFT +
HTK mel filterbank so extraction runs anywhere.
"""
from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
N_MELS = 128
WIN_LENGTH = int(0.025 * SAMPLE_RATE)   # 25 ms
HOP_LENGTH = int(0.010 * SAMPLE_RATE)   # 10 ms
N_FFT = 512


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE, fmin: float = 20.0,
                   fmax: float | None = None) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular HTK-mel filterbank."""
    fmax = fmax or sr / 2
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    # continuous triangular weights over the FFT bin centers (kaldi weights
    # bins in the mel domain rather than rounding edges to integer bins,
    # which at 128 mels / 512-pt FFT would zero out low-frequency rows)
    fft_freqs = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    lo, c, hi = hz_pts[:-2, None], hz_pts[1:-1, None], hz_pts[2:, None]
    rising = (fft_freqs[None] - lo) / np.maximum(c - lo, 1e-9)
    falling = (hi - fft_freqs[None]) / np.maximum(hi - c, 1e-9)
    return np.maximum(0.0, np.minimum(rising, falling)).astype(np.float32)


def log_mel_spectrogram(wav: np.ndarray, sr: int = SAMPLE_RATE,
                        n_mels: int = N_MELS, n_fft: int = N_FFT,
                        win_length: int = WIN_LENGTH,
                        hop_length: int = HOP_LENGTH) -> np.ndarray:
    """wav (n_samples,) float → (n_frames, n_mels) log-mel (natural log,
    like kaldi fbank)."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=-1)
    wav = wav - wav.mean()  # global DC removal (reference: audio_loader.py:75,
    #                         extract_audio_features.py:87)
    n_frames = max(1 + (len(wav) - win_length) // hop_length, 1)
    if len(wav) < win_length:
        wav = np.pad(wav, (0, win_length - len(wav)))
    idx = (np.arange(win_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = wav[idx]
    # kaldi fbank per-frame defaults (torchaudio.compliance.kaldi.fbank,
    # which the reference calls): remove_dc_offset=True then
    # preemphasis_coefficient=0.97 with the first sample reflected
    frames = frames - frames.mean(axis=1, keepdims=True)
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - 0.97 * pre
    window = np.hanning(win_length).astype(np.float32)
    frames = frames * window[None]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    fb = mel_filterbank(n_mels, n_fft, sr)
    mel = spec @ fb.T
    return np.log(np.maximum(mel, 1e-10)).astype(np.float32)


def chunk_and_stack(mel: np.ndarray, n_chunks: int = 10,
                    image_size: int = 224, target_length: int = 2240,
                    audio_mean: float | None = None,
                    audio_std: float | None = None) -> np.ndarray:
    """(T, 128) mel → (n_chunks, 3, image_size, image_size) CLIP-ready
    chunk images, following the reference's AudioLoader.waveform2melspec
    (audio_loader.py:35-72): repeat-pad short mels to target_length, split
    into target_length//n_chunks-frame chunks (ragged tail dropped), stack
    ×3 channels, and normalize with the DATASET-GLOBAL
    (x − audio_mean) / (2·audio_std) when stats are given (the reference
    takes them as required CLI args). Deviation kept deliberately: each
    chunk is bilinear-resized to image_size² — the reference feeds raw
    (3, 128, 224) chunks to CLIP ViT-L/14, whose patch/position embedding
    only accepts 224×224. Without stats, falls back to per-chunk whitening
    (deterministic, self-contained — suitable for synthetic runs)."""
    t = mel.shape[0]
    if t < target_length:  # repeat-pad (audio_loader.py:38-40)
        n_repeat = target_length // t + 1
        mel = np.tile(mel, (n_repeat, 1))[:target_length]
    per = target_length // n_chunks
    chunks = []
    for i in range(n_chunks):
        c = mel[i * per:(i + 1) * per]
        if len(c) < per:
            break  # ragged tail dropped (audio_loader.py:43-44)
        img = _resize_bilinear(c, image_size, image_size)
        if audio_mean is not None and audio_std is not None:
            img = (img - audio_mean) / (2.0 * audio_std)
        else:
            mean, std = img.mean(), img.std() + 1e-6
            img = (img - mean) / std
        chunks.append(np.stack([img, img, img]))
    return np.stack(chunks[:n_chunks]).astype(np.float32)


def three_crop_mel(mel: np.ndarray, target_length: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """(T, n_mels) mel → (3, n_mels, target_length) front/middle/back crop
    fusion — the reference's second audio transform
    (reference: extract_audio_features.py:42-82 waveform2melspec):

      * T > target: the valid start range [0, T-target] is split into three
        parts; one start index is drawn per part (empty middle/back parts
        fall back to index 0). rng=None picks each part's FIRST index —
        deterministic extraction (the commented-out 'fixed' variant,
        extract_audio_features.py:62-64).
      * T < target: repeat-tile the mel up to target and stack it ×3.
      * T == target: stack ×3.
    """
    mel = np.asarray(mel, np.float32)
    t = mel.shape[0]
    if t > target_length:
        starts = np.arange(0, t - target_length + 1)
        ranges = np.array_split(starts, 3)
        ranges = [r if len(r) else np.array([0]) for r in ranges]
        if rng is None:
            picks = [int(r[0]) for r in ranges]
        else:
            picks = [int(rng.choice(r)) for r in ranges]
        fusion = np.stack([mel[p:p + target_length] for p in picks])
    elif t < target_length:
        n_repeat = target_length // t + 1
        tiled = np.tile(mel, (n_repeat, 1))[:target_length]
        fusion = np.stack([tiled, tiled, tiled])
    else:
        fusion = np.stack([mel, mel, mel])
    # (3, target, n_mels) → (3, n_mels, target), extract_audio_features.py:80
    return fusion.transpose(0, 2, 1).astype(np.float32)


def _resize_bilinear(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Minimal bilinear resize (avoid cv2/PIL dependency in the hot path)."""
    sh, sw = x.shape
    ys = np.linspace(0, sh - 1, h)
    xs = np.linspace(0, sw - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = x[np.ix_(y0, x0)]
    b = x[np.ix_(y0, x1)]
    c = x[np.ix_(y1, x0)]
    d = x[np.ix_(y1, x1)]
    return ((a * (1 - wx) + b * wx) * (1 - wy)
            + (c * (1 - wx) + d * wx) * wy).astype(np.float32)
