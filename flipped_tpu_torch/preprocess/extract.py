"""Offline feature extraction: videos → CLIP ViT-L/14 features, audio →
mel-as-image CLIP features (JAX: flipped_tpu/preprocess/extract.py; the
port keeps its own copy). The CLIP encoder runs on an explicit torch
device, the card by default (`--device cuda`; `--device cpu` without one).

Replaces the reference's preprocess/ scripts (reference: preprocess/extract.py,
extract_audio_features.py, extract_raw_audio.py): frames are read at 1 fps via
OpenCV (moviepy dropped), the image encoder is CLIP ViT-L/14 via HuggingFace
transformers (the `clip` pip package dropped), and audio mels come from the
numpy pipeline in mel.py (torchaudio dropped). This is an offline CPU/GPU
job — its outputs are the `clipvitl14.pth` / audio feature stores the
training data layer consumes.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, List

import numpy as np

CLIP_MODEL = "openai/clip-vit-large-patch14"
CLIP_INPUT = 224
_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def read_frames(video_path: str, fps: float = 1.0) -> np.ndarray:
    """Decode ~fps frames/sec → (n, 224, 224, 3) float in [0,1] (reference
    samples 1 fps for clipvitl14 features)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    native = cap.get(cv2.CAP_PROP_FPS) or 25.0
    step = max(int(round(native / fps)), 1)
    frames: List[np.ndarray] = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % step == 0:
            frame = cv2.resize(frame, (CLIP_INPUT, CLIP_INPUT))
            frames.append(frame[:, :, ::-1].astype(np.float32) / 255.0)
        i += 1
    cap.release()
    if not frames:
        return np.zeros((1, CLIP_INPUT, CLIP_INPUT, 3), np.float32)
    return np.stack(frames)


def _load_clip(device="cuda"):
    import torch
    from transformers import CLIPVisionModelWithProjection

    model = CLIPVisionModelWithProjection.from_pretrained(CLIP_MODEL)
    model.eval()
    return model.to(device), torch


def encode_images(frames: np.ndarray, model=None, batch: int = 32,
                  device="cuda") -> np.ndarray:
    """(n, 224, 224, 3) in [0,1] → (n, 768) CLIP image embeddings
    (reference: extract.py:151-186, fp16 output), computed on `device`."""
    if model is None:
        model = _load_clip(device)
    clip_model, torch = model
    x = (frames - _CLIP_MEAN) / _CLIP_STD
    x = np.transpose(x, (0, 3, 1, 2))
    outs = []
    with torch.no_grad():
        for i in range(0, len(x), batch):
            t = torch.tensor(x[i:i + batch], dtype=torch.float32,
                             device=device)
            outs.append(clip_model(pixel_values=t).image_embeds.float()
                        .cpu().numpy())
    return np.concatenate(outs).astype(np.float16)


def extract_video_features(video_dir: str, out_path: str, fps: float = 1.0,
                           device="cuda"):
    import torch

    model = _load_clip(device)
    feats: Dict[str, "torch.Tensor"] = {}
    videos = sorted(p for p in Path(video_dir).iterdir()
                    if p.suffix.lower() in (".mp4", ".avi", ".mkv", ".webm"))
    for p in videos:
        frames = read_frames(str(p), fps)
        feats[p.stem] = torch.tensor(encode_images(frames, model,
                                                   device=device))
        print(f"{p.stem}: {tuple(feats[p.stem].shape)}")
    torch.save(feats, out_path)
    print(f"saved {len(feats)} videos → {out_path}")


def write_wav(path: str, wav: np.ndarray, sr: int = 16000):
    """float [-1,1] mono → 16-bit PCM .wav (stdlib only)."""
    import wave

    data = (np.clip(np.asarray(wav, np.float32), -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def read_wav_16k(path: str) -> np.ndarray:
    """16-bit mono 16 kHz wav → float32 in [-1, 1). The downstream mel
    constants (mel.WIN/HOP) are fixed at 16 kHz, so anything else must be
    rejected loudly — np.frombuffer would silently misparse stereo or
    24/32-bit PCM into garbage features."""
    import wave

    with wave.open(str(path)) as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, 16000):
            raise ValueError(
                f"{path}: expected 16-bit mono 16 kHz wav, got "
                f"channels={w.getnchannels()} sampwidth={w.getsampwidth()} "
                f"rate={w.getframerate()} — re-extract with "
                f"`preprocess.extract raw-audio` (resamples to 16 kHz mono)")
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return data.astype(np.float32) / 32768.0


def audio_backend() -> str | None:
    """First available video→audio decoder: ffmpeg (no python deps) else
    moviepy (the reference's choice, extract_raw_audio.py:2)."""
    import shutil

    if shutil.which("ffmpeg"):
        return "ffmpeg"
    try:
        import moviepy.editor  # noqa: F401
        return "moviepy"
    except Exception:
        return None


def extract_wav(video_path: str, wav_path: str, sr: int = 16000,
                backend: str | None = None):
    """One video → mono 16 kHz .wav (reference: extract_raw_audio.py:9-12)."""
    import subprocess

    backend = backend or audio_backend()
    if backend == "ffmpeg":
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path, "-vn",
             "-ac", "1", "-ar", str(sr), "-f", "wav", wav_path],
            check=True, capture_output=True)
    elif backend == "moviepy":
        from moviepy.editor import VideoFileClip

        VideoFileClip(video_path).audio.write_audiofile(
            wav_path, fps=sr, nbytes=2, logger=None)
    else:
        raise RuntimeError(
            "video→wav extraction needs ffmpeg on PATH or the moviepy "
            "package; neither is available")


def extract_raw_audio(video_dir: str, out_dir: str, sr: int = 16000,
                      to_wav=extract_wav) -> int:
    """All videos under video_dir → {out_dir}/{stem}.wav; per-file failures
    are reported and skipped (reference: extract_raw_audio.py:33-38
    try/except). Returns the number extracted."""
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    videos = sorted(p for p in Path(video_dir).iterdir()
                    if p.suffix.lower() in (".mp4", ".avi", ".mkv", ".webm"))
    for p in videos:
        wav_path = os.path.join(out_dir, p.stem + ".wav")
        try:
            to_wav(str(p), wav_path, sr)
            done += 1
        except Exception as exc:  # noqa: BLE001 — match reference behavior
            print(f"cannot extract {p.stem}.wav from {p}: {exc}")
    print(f"extracted {done}/{len(videos)} wavs → {out_dir}")
    return done


def extract_audio_mels(wav_dir: str, out_dir: str, target_length: int = 1024,
                       seed: int | None = None) -> int:
    """wav → (3, 128, target_length) three-crop log-mel fusion .npy per clip
    — the reference's second audio transform, kept as mel tensors for an
    audio encoder (reference: extract_audio_features.py:24-99). seed=None →
    deterministic first-index crops; an int seeds the reference's random
    per-part crop choice."""
    import wave

    from .mel import log_mel_spectrogram, three_crop_mel

    os.makedirs(out_dir, exist_ok=True)
    rng = None if seed is None else np.random.default_rng(seed)
    wavs = sorted(Path(wav_dir).glob("*.wav"))
    for p in wavs:
        wavf = read_wav_16k(p)
        mel = log_mel_spectrogram(wavf)
        fusion = three_crop_mel(mel, target_length, rng)
        np.save(os.path.join(out_dir, p.stem + ".npy"), fusion)
        print(f"{p.stem}: {fusion.shape}")
    print(f"saved {len(wavs)} mel fusions → {out_dir}")
    return len(wavs)


def extract_audio_features(wav_dir: str, out_path: str, n_chunks: int = 10,
                           target_length: int = 2240,
                           audio_mean: float | None = None,
                           audio_std: float | None = None, device="cuda"):
    """wav → log-mel → 10 chunk images → CLIP image encoder → (10, 768)
    (reference: extract.py:151-186 over audio_loader.py chunks)."""
    import torch

    from .mel import chunk_and_stack, log_mel_spectrogram

    model = _load_clip(device)
    feats: Dict[str, "torch.Tensor"] = {}
    for p in sorted(Path(wav_dir).glob("*.wav")):
        wavf = read_wav_16k(p)
        mel = log_mel_spectrogram(wavf)
        chunks = chunk_and_stack(mel, n_chunks,           # (10,3,224,224)
                                 target_length=target_length,
                                 audio_mean=audio_mean, audio_std=audio_std)
        imgs = np.transpose(chunks, (0, 2, 3, 1))
        # chunks are already normalized; bypass CLIP renorm
        imgs = imgs * _CLIP_STD + _CLIP_MEAN
        feats[p.stem] = torch.tensor(encode_images(imgs, model,
                                                   device=device))
        print(f"{p.stem}: {tuple(feats[p.stem].shape)}")
    torch.save(feats, out_path)
    print(f"saved {len(feats)} clips → {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("video")
    v.add_argument("--video_dir", required=True)
    v.add_argument("--out", required=True)
    v.add_argument("--fps", type=float, default=1.0)
    a = sub.add_parser("audio")
    a.add_argument("--wav_dir", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--n_chunks", type=int, default=10)
    a.add_argument("--target_length", type=int, default=2240,
                   help="mel frames per clip before chunking (reference "
                        "extract.py --targetlength default)")
    a.add_argument("--audio_mean", type=float, default=None)
    a.add_argument("--audio_std", type=float, default=None,
                   help="dataset-global normalization stats "
                        "(reference: (x-mean)/(2*std), audio_loader.py:72); "
                        "omitted → per-chunk whitening")
    r = sub.add_parser("raw-audio", help="videos → 16 kHz .wav files "
                       "(reference: extract_raw_audio.py)")
    r.add_argument("--video_dir", required=True)
    r.add_argument("--out_dir", required=True)
    r.add_argument("--sr", type=int, default=16000)
    m = sub.add_parser("audio-mel", help="wavs → 3-crop log-mel .npy "
                       "(reference: extract_audio_features.py)")
    m.add_argument("--wav_dir", required=True)
    m.add_argument("--out_dir", required=True)
    m.add_argument("--target_length", type=int, default=1024)
    m.add_argument("--seed", type=int, default=None,
                   help="seed the random per-part crops; default = "
                        "deterministic first-index crops")
    for p in (v, a):
        p.add_argument("--device", default="cuda",
                       help="where the CLIP encoder runs")
    args = ap.parse_args(argv)
    if args.cmd == "video":
        extract_video_features(args.video_dir, args.out, args.fps,
                               args.device)
    elif args.cmd == "audio":
        extract_audio_features(args.wav_dir, args.out, args.n_chunks,
                               target_length=args.target_length,
                               audio_mean=args.audio_mean,
                               audio_std=args.audio_std, device=args.device)
    elif args.cmd == "raw-audio":
        extract_raw_audio(args.video_dir, args.out_dir, args.sr)
    else:
        extract_audio_mels(args.wav_dir, args.out_dir, args.target_length,
                           args.seed)


if __name__ == "__main__":
    main()
