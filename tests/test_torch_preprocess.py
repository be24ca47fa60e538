"""The port's offline preprocessing (flipped_tpu_torch/preprocess) against
the JAX package's, on the cases of tests/test_preprocess.py: the numpy
log-mel pipeline, the three-crop fusion, the wav reader and writer, the
video-to-wav orchestration, the wav-to-mel CLI path, frame decoding and
the CLIP encode around a stand-in encoder (the CLIP weights are a
download, so no test needs them). Every output equals JAX's exactly."""
import os

import numpy as np
import pytest
import torch

from flipped_tpu.preprocess import extract as jextract
from flipped_tpu.preprocess import mel as jmel
from flipped_tpu_torch.preprocess import extract, mel


def _sine(seconds: float, sr: int = 16000, hz: float = 440.0) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["sine", "dc_shift", "short", "stereo"])
def test_log_mel_equals_jax(case):
    wav = {"sine": _sine(1.0), "dc_shift": _sine(1.0) + 0.3,
           "short": _sine(0.01),
           "stereo": np.stack([_sine(0.5), _sine(0.5, hz=220.0)], -1)}[case]
    _same(mel.log_mel_spectrogram(wav), jmel.log_mel_spectrogram(wav))


def test_filterbank_and_mel_scale_equal_jax():
    _same(mel.mel_filterbank(), jmel.mel_filterbank())
    _same(mel.mel_filterbank(64, 400, 8000, fmin=0.0, fmax=4000.0),
          jmel.mel_filterbank(64, 400, 8000, fmin=0.0, fmax=4000.0))
    f = np.linspace(0, 8000, 17)
    _same(mel.hz_to_mel(f), jmel.hz_to_mel(f))
    _same(mel.mel_to_hz(mel.hz_to_mel(f)), jmel.mel_to_hz(jmel.hz_to_mel(f)))


@pytest.mark.parametrize("stats", [None, (-4.0, 3.0)])
def test_chunk_and_stack_equals_jax(stats):
    m = jmel.log_mel_spectrogram(_sine(2.0))
    kw = {} if stats is None else dict(audio_mean=stats[0],
                                       audio_std=stats[1])
    got = mel.chunk_and_stack(m, n_chunks=10, **kw)
    assert got.shape == (10, 3, 224, 224)
    _same(got, jmel.chunk_and_stack(m, n_chunks=10, **kw))


@pytest.mark.parametrize("t, target, seeded", [
    (300, 100, False), (300, 100, True), (40, 100, False), (50, 50, False)])
def test_three_crop_equals_jax(t, target, seeded):
    m = np.random.default_rng(1).standard_normal((t, 8)).astype(np.float32)
    rng = (lambda: np.random.default_rng(0)) if seeded else (lambda: None)
    _same(mel.three_crop_mel(m, target, rng()),
          jmel.three_crop_mel(m, target, rng()))


def test_wav_roundtrip_and_16k_guard(tmp_path):
    extract.write_wav(str(tmp_path / "a.wav"), _sine(0.5))
    jextract.write_wav(str(tmp_path / "b.wav"), _sine(0.5))
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav"
                                                 ).read_bytes()
    _same(extract.read_wav_16k(tmp_path / "a.wav"),
          jextract.read_wav_16k(tmp_path / "a.wav"))
    extract.write_wav(str(tmp_path / "c.wav"), _sine(0.5), sr=8000)
    with pytest.raises(ValueError, match="16 kHz"):
        extract.read_wav_16k(tmp_path / "c.wav")


def test_extract_raw_audio_orchestration(tmp_path, capsys):
    """Walks the videos, converts each, skips failures: the same files as
    JAX's, with the backend injected (no ffmpeg or moviepy here)."""
    vdir = tmp_path / "videos"
    vdir.mkdir()
    for name in ("a.mp4", "b.mkv", "broken.mp4", "notvideo.txt"):
        (vdir / name).write_bytes(b"x")

    def fake_to_wav(video_path, wav_path, sr):
        if "broken" in video_path:
            raise ValueError("no audio stream")
        extract.write_wav(wav_path, _sine(0.1), sr)

    assert extract.extract_raw_audio(str(vdir), str(tmp_path / "p"),
                                     to_wav=fake_to_wav) == 2
    assert jextract.extract_raw_audio(str(vdir), str(tmp_path / "j"),
                                      to_wav=fake_to_wav) == 2
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j")) == ["a.wav", "b.wav"]
    assert extract.audio_backend() == jextract.audio_backend()
    capsys.readouterr()


def test_extract_audio_mels_equals_jax(tmp_path, capsys):
    wdir = tmp_path / "wavs"
    wdir.mkdir()
    extract.write_wav(str(wdir / "clip1.wav"), _sine(2.0))
    extract.write_wav(str(wdir / "clip2.wav"), _sine(0.2))  # shorter
    for seed in (None, 3):
        assert extract.extract_audio_mels(str(wdir), str(tmp_path / "p"),
                                          128, seed) == 2
        assert jextract.extract_audio_mels(str(wdir), str(tmp_path / "j"),
                                           128, seed) == 2
        for stem in ("clip1", "clip2"):
            got = np.load(tmp_path / "p" / f"{stem}.npy")
            assert got.shape == (3, 128, 128)
            _same(got, np.load(tmp_path / "j" / f"{stem}.npy"))
    capsys.readouterr()


def test_read_frames_equals_jax(tmp_path):
    import cv2

    path = str(tmp_path / "v.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 4.0, (32, 24))
    for i in range(10):
        w.write(np.full((24, 32, 3), (i * 20, 5 * i, 255 - i), np.uint8))
    w.release()
    got = extract.read_frames(path, fps=1.0)
    assert got.shape == (3, 224, 224, 3)
    _same(got, jextract.read_frames(path, fps=1.0))


class _Encoder(torch.nn.Module):
    """A stand-in for CLIP's vision tower: image_embeds from pixel means."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 768)
        torch.nn.init.normal_(self.proj.weight, generator=torch.Generator()
                              .manual_seed(0))

    def forward(self, pixel_values):
        class Out:
            pass
        out = Out()
        out.image_embeds = self.proj(pixel_values.mean((2, 3)))
        return out


def test_encode_images_on_an_explicit_device_equals_jax():
    frames = np.random.default_rng(2).random((5, 224, 224, 3),
                                             dtype=np.float32)
    enc = _Encoder().eval()
    got = extract.encode_images(frames, (enc, torch), batch=2, device="cpu")
    assert got.dtype == np.float16 and got.shape == (5, 768)
    _same(got, jextract.encode_images(frames, (enc, torch), batch=2))
