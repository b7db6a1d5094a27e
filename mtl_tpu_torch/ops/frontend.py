"""Log-spectrogram front-end on the device (port of mtl_tpu/ops/frontend.py).

Reference pipeline (utils/data_loader.py:65-96): librosa STFT with
n_fft = sr*window_size, hop = sr*window_stride, symmetric hamming window,
center=True reflect padding; log1p(|D|); per-utterance mean/std normalize
with torch's unbiased std. Here the whole padded batch is transformed at
once: the windowed STFT runs as ``ops/stft.py:stft_logmag`` (a CUDA kernel on
the card, an FFT for the usual n_fft), then the masked per-utterance
normalize.

The waveforms normally arrive prepadded (data/dataset.py:collate_audio
reflect-pads each utterance by n_fft//2 on both sides), which is what exact
librosa parity on zero-padded batches needs. ``log_fbank`` is the other
front-end (``--feat logfbank``), a log-mel filterbank of the raw waveforms.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import strict_f32

# the windows and DFT bases live beside the kernel that uses them
from .stft import device_dft_matrices, dft_matrices  # noqa: F401
from .stft import frames_from_prepadded, stft_logmag


def num_frames(num_samples: torch.Tensor, n_fft: int,
               hop: int) -> torch.Tensor:
    """Frame count for center=True STFT: 1 + n_samples // hop."""
    return 1 + num_samples // hop


def _reflect_pad(audio: torch.Tensor, n_fft: int) -> torch.Tensor:
    pad = n_fft // 2
    return F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]


def frame_tail(audio: torch.Tensor, n_fft: int, hop: int,
               n_frames: int) -> torch.Tensor:
    """The prepadded [B, S] waveforms extended so that the last of
    ``n_frames`` frames reads what the JAX package's framing gives it. At an
    odd n_fft that frame runs one sample past the row's end; where hop does
    not divide n_fft, JAX frames by a gather, which clamps the index (the
    row's last sample again; mtl_tpu/ops/frontend.py:124-125), and the STFT
    kernels read zeros past the end: so the last sample is repeated here.
    Where hop divides n_fft JAX pads zeros, as the kernels do."""
    need = (n_frames - 1) * hop + n_fft
    if n_fft % hop == 0 or need <= audio.shape[1]:
        return audio
    tail = audio[:, -1:].expand(-1, need - audio.shape[1])
    return torch.cat([audio, tail], dim=1)


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int,
                 prepadded: bool = False) -> torch.Tensor:
    """[B, S] -> [B, T, n_fft] frames with center reflect padding,
    T = 1 + S // hop (librosa center=True). ``prepadded=True``: the host
    already reflect-padded each utterance by n_fft//2 on both sides."""
    pad = n_fft // 2
    if prepadded:
        s = audio.shape[1] - 2 * pad
    else:
        s = audio.shape[1]
        audio = _reflect_pad(audio, n_fft)
    t = 1 + s // hop
    return frames_from_prepadded(frame_tail(audio, n_fft, hop, t), n_fft,
                                 hop, t)


def log_spectrogram(
    audio: torch.Tensor,  # [B, S] float32 padded waveforms
    audio_lengths: torch.Tensor,  # [B] valid sample counts
    n_fft: int,
    hop: int,
    window: str = "hamming",
    normalize: bool = True,
    prepadded: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT -> log1p(|.|) -> masked per-utterance normalize.

    Returns (features [B, T, F], frame_lengths [B])."""
    pad = n_fft // 2
    s = audio.shape[1] - 2 * pad if prepadded else audio.shape[1]
    if not prepadded:
        audio = _reflect_pad(audio, n_fft)
    t = 1 + s // hop
    audio = frame_tail(audio.float(), n_fft, hop, t)
    spect = stft_logmag(audio.contiguous(), n_fft, hop, t, window)

    frame_lengths = torch.clamp(num_frames(audio_lengths, n_fft, hop), max=t)
    if normalize:
        spect = normalize_per_utterance(spect, frame_lengths)
    # zero padded frames so downstream convs see clean zeros
    valid = _valid_frames(frame_lengths, t)
    return torch.where(valid, spect, 0.0), frame_lengths


def _valid_frames(frame_lengths: torch.Tensor, t: int) -> torch.Tensor:
    pos = torch.arange(t, device=frame_lengths.device)
    return (pos[None, :] < frame_lengths[:, None])[..., None]


def normalize_per_utterance(spect: torch.Tensor,
                            frame_lengths: torch.Tensor) -> torch.Tensor:
    """Masked per-utterance mean/std normalize; unbiased std (torch
    parity), floored at max(n - 1, 1), rsqrt(var + 1e-12)."""
    b, t, f = spect.shape
    valid = _valid_frames(frame_lengths, t)
    n = (frame_lengths * f).float()[:, None, None]
    masked = torch.where(valid, spect, 0.0)
    mean = masked.sum(dim=(1, 2), keepdim=True) / n
    sq = torch.where(valid, (spect - mean) ** 2, 0.0)
    var = sq.sum(dim=(1, 2), keepdim=True) / torch.clamp(n - 1.0, min=1.0)
    return (spect - mean) * torch.rsqrt(var + 1e-12) * valid


# -- log-mel filterbank front-end (mtl_tpu/ops/frontend.py:193-300) -------
# python_speech_features.logfbank parity, the reference's LogFBankDataset
# front-end (utils/data_loader.py:145-155): logfbank(sig, rate, nfilt=80)
# with psf's defaults winlen 0.025, winstep 0.01, nfft 512, preemph 0.97,
# a rectangular window, the power spectrum |rfft|^2 / nfft and a log with
# an eps floor. Plain torch: the JAX package computes it with einsums, not
# a Pallas kernel; its DFT and mel products run in f32 with TF32 off.

def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(nfilt: int, nfft: int, sample_rate: int,
                   lowfreq: float = 0.0,
                   highfreq: Optional[float] = None) -> np.ndarray:
    """[nfft//2+1, nfilt] triangular mel filters (psf get_filterbanks)."""
    highfreq = highfreq or sample_rate / 2.0
    mels = np.linspace(hz_to_mel(lowfreq), hz_to_mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel_to_hz(mels) / sample_rate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1), np.float64)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank.T.astype(np.float32)


def psf_num_frames(num_samples, winlen: int, hop: int):
    """python_speech_features framesig's frame count (no centering; the
    final partial frame zero-padded), of an int or a tensor of counts."""
    if isinstance(num_samples, (int, np.integer)):
        if num_samples <= winlen:
            return 1
        return 1 + int(np.ceil((num_samples - winlen) / hop))
    n = torch.ceil((num_samples - winlen) / hop).long() + 1
    return torch.where(num_samples <= winlen, 1, n)


@functools.lru_cache(maxsize=4)
def dft_matrices_rect(nfft: int, win: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rectangular-window DFT basis truncated to ``win`` rows (frames
    shorter than nfft are zero-padded in psf, which equals dropping basis
    rows): (cos [win, F], -sin [win, F])."""
    f = nfft // 2 + 1
    n = np.arange(win, dtype=np.float64)[:, None]
    k = np.arange(f, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _fbank_tables(nfft: int, win: int, nfilt: int, sample_rate: int,
                  device: torch.device):
    """The DFT bases and the mel filters on ``device``, copied once."""
    cos_b, nsin_b = dft_matrices_rect(nfft, win)
    return tuple(torch.from_numpy(a).to(device) for a in (
        cos_b, nsin_b, mel_filterbank(nfilt, nfft, sample_rate)))


def log_fbank(audio: torch.Tensor, audio_lengths: torch.Tensor,
              sample_rate: int = 16000, nfilt: int = 80,
              winlen: float = 0.025, winstep: float = 0.01, nfft: int = 512,
              preemph: float = 0.97, normalize: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preemphasis -> frames -> |DFT|^2 / nfft -> mel -> log of a batch of
    raw (not prepadded) waveforms [B, S] with valid lengths [B]. Returns
    (features [B, T, nfilt], frame_lengths [B])."""
    win = int(winlen * sample_rate)
    hop = int(winstep * sample_rate)
    b, s = audio.shape
    audio = audio.float()
    x = torch.cat([audio[:, :1], audio[:, 1:] - preemph * audio[:, :-1]],
                  dim=1)
    # psf preemphasizes the unpadded signal: zero what lies past each
    # utterance, -preemph * audio[len - 1] included
    pos = torch.arange(s, device=audio.device)
    x = torch.where(pos[None, :] < audio_lengths[:, None], x, 0.0)
    n_t = psf_num_frames(s, win, hop)
    # frames from r hop-sized chunks side by side, cut to the window
    r = int(np.ceil(win / hop))
    need = (n_t - 1 + r) * hop
    if s < need:
        x = F.pad(x, (0, need - s))
    chunks = x[:, :need].reshape(b, -1, hop)
    frames = torch.cat([chunks[:, i:i + n_t] for i in range(r)],
                       dim=-1)[:, :, :win]
    cos_b, nsin_b, fb = _fbank_tables(nfft, win, nfilt, sample_rate,
                                      audio.device)
    with strict_f32():
        re, im = frames @ cos_b, frames @ nsin_b
        feat = ((re * re + im * im) / nfft) @ fb
    feat = torch.log(torch.clamp(feat, min=float(np.finfo(np.float32).eps)))
    frame_lengths = torch.clamp(psf_num_frames(audio_lengths, win, hop),
                                max=feat.shape[1])
    if normalize:
        feat = normalize_per_utterance(feat, frame_lengths)
    return (torch.where(_valid_frames(frame_lengths, feat.shape[1]), feat,
                        0.0), frame_lengths)
