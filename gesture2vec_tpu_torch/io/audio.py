"""Audio loading and mel-spectrogram features, self-contained.

The port's copy of the JAX package's `io/audio.py`.

The reference uses librosa for 16 kHz loading
(ref: trinity_data_to_lmdb.py:93-94) and per-second mel spectrograms
(ref: data_preprocessor.py:257-264, librosa.feature.melspectrogram with
fmin=20, fmax=7600, hop_length=655, n_mels=80 over 36267-sample chunks).
librosa is not a dependency here: WAV decode goes through scipy and the
mel filterbank/STFT are implemented directly (Slaney-style filterbank,
matching librosa defaults).
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

# reference mel settings (ref: data_preprocessor.py:257-264)
MEL_FMIN = 20.0
MEL_FMAX = 7600.0
MEL_HOP = 655
MEL_N = 80
AUDIO_SR = 16000


def load_wav(path: str, target_sr: int = AUDIO_SR) -> np.ndarray:
    """Mono float32 waveform resampled to target_sr."""
    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.uint8:
        # 8-bit PCM is unsigned, centered at 128
        data = (data.astype(np.float32) - 128.0) / 128.0
    elif np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    else:
        data = data.astype(np.float32)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def _hz_to_mel(f):
    """Slaney mel scale (librosa default htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) Slaney-normalized triangular filterbank."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                     n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def stft_power(y: np.ndarray, n_fft: int = 2048,
               hop_length: int = MEL_HOP) -> np.ndarray:
    """|STFT|^2 with centered Hann windowing (librosa-compatible pad)."""
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    idx = (np.arange(n_fft)[None, :] +
           hop_length * np.arange(n_frames)[:, None])
    frames = y[idx] * window
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return (spec.real ** 2 + spec.imag ** 2).T.astype(np.float32)


def power_to_db(power: np.ndarray, top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db(ref=np.max) equivalent."""
    ref = max(float(power.max()), 1e-10)
    db = 10.0 * np.log10(np.maximum(power, 1e-10) / ref)
    return np.maximum(db, -top_db).astype(np.float32)


def mel_chunks_per_second(y: np.ndarray, sr: int = AUDIO_SR,
                          n_mels: int = 128, hop_length: int = 512
                          ) -> np.ndarray:
    """Per-second mel chunks for the audio-context models
    (ref: data_preprocessor.py:256-263: 1-second chunks through
    melspectrogram with library defaults, then power_to_db(ref=max)).
    Returns (n_seconds, n_mels, ~32) float32."""
    n_sec = len(y) // sr
    fb = mel_filterbank(sr, 2048, n_mels, 0.0, sr / 2)
    chunks = []
    for k in range(n_sec):
        power = stft_power(y[k * sr:(k + 1) * sr], n_fft=2048,
                           hop_length=hop_length)
        chunks.append(power_to_db(fb @ power))
    return (np.stack(chunks, axis=0) if chunks
            else np.zeros((0, n_mels, 1), np.float32))


def mel_spectrogram(y: np.ndarray, sr: int = AUDIO_SR,
                    n_mels: int = MEL_N, hop_length: int = MEL_HOP,
                    fmin: float = MEL_FMIN, fmax: float = MEL_FMAX,
                    n_fft: int = 2048, log: bool = True) -> np.ndarray:
    """(n_mels, frames) mel power spectrogram; log-compressed by default
    like the reference's np.log(melspectrogram)
    (ref: data_preprocessor.py:263-264)."""
    power = stft_power(y, n_fft=n_fft, hop_length=hop_length)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    mel = fb @ power
    if log:
        mel = np.log(np.maximum(mel, 1e-10))
    return mel
