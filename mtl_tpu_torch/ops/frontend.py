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
librosa parity on zero-padded batches needs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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
    return frames_from_prepadded(audio, n_fft, hop, 1 + s // hop)


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
    spect = stft_logmag(audio.float().contiguous(), n_fft, hop, t, window)

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
