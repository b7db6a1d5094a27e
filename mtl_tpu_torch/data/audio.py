"""Host-side audio I/O and augmentation (port of mtl_tpu/data/audio.py).

Containers, sniffed from the first bytes as the JAX package does
(``load_audio_with_rate``; the reference reads all of them through
torchaudio, utils/audio.py:7-12, with a channel-mean mixdown):

* WAV (PCM 8/16/24/32, IEEE float, WAVE_FORMAT_EXTENSIBLE) through the
  native core ``csrc/host/audio_io.cpp``, else the stdlib ``wave`` module
  and a minimal RIFF parser for what ``wave`` rejects;
* FLAC through the native core's decoder (``ValueError`` when the library
  cannot be built);
* mp3 through the system ``libmpg123.so.0`` and ogg/vorbis through
  ``libvorbisfile.so.3``, by ctypes (``OSError`` when the library is
  absent);
* ``.npy`` arrays for fixtures (rate reported as 0, unknown).

Augmentation (utils/audio.py:49-61, utils/data_loader.py:367-399):
``augment_audio`` draws a tempo in [0.85, 1.15] and a gain in [-6, 8] dB
from the passed ``RandomState`` and applies them through the linear
resampler (native, else numpy); ``NoiseInjector`` mixes a random segment
of a random noise file at a random level scaled by the energy ratio. The
native library is built by ``utils/host_native.py`` at first use.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import wave
from typing import Optional, Tuple

import numpy as np

from ..utils import host_native


@functools.lru_cache(maxsize=None)
def _load_native() -> Optional[ctypes.CDLL]:
    """The native audio core with its signatures, or None."""
    lib = host_native.load("audio_io")
    if lib is None:
        return None
    lib.wav_probe.restype = ctypes.c_int32
    lib.wav_probe.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int32)]
    lib.wav_decode.restype = ctypes.c_int32
    lib.wav_decode.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int64]
    lib.resample_linear_f32.restype = None
    lib.resample_linear_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    lib.flac_probe.restype = ctypes.c_int32
    lib.flac_probe.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int32)]
    lib.flac_decode.restype = ctypes.c_int64
    lib.flac_decode.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64]
    return lib


def _native_decode(path: str) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load_native()
    if lib is None:
        return None
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    p = path.encode()
    if lib.wav_probe(p, ctypes.byref(n), ctypes.byref(sr)) != 0:
        return None  # unsupported codec/container -> Python fallback
    out = np.empty(n.value, np.float32)
    if lib.wav_decode(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      n.value) != 0:
        return None
    return out, sr.value


def _pcm_to_float(raw: bytes, width: int, path: str) -> np.ndarray:
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if width == 1:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    if width == 3:  # 24-bit packed
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        y = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        y = np.where(y >= 1 << 23, y - (1 << 24), y)
        return y.astype(np.float32) / float(1 << 23)
    raise ValueError(f"unsupported sample width {width} in {path}")


def _load_wav_riff(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE parser for formats the stdlib ``wave`` module
    rejects: IEEE-float (format 3) and WAVE_FORMAT_EXTENSIBLE (0xFFFE)
    wrapping PCM or float. Covers the float-WAV exports common in
    CommonVoice-style corpora without any native dependency."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(
                f"unsupported audio container in {path!r}: not RIFF/WAVE, "
                "FLAC, ogg, or mp3 (convert other codecs to wav or .npy)"
            )
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"malformed WAV (missing fmt/data chunk): {path!r}")
    (audio_format, n_ch, rate, _byte_rate, _block, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # EXTENSIBLE: subformat GUID
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 3:  # IEEE float
        dtype = {32: "<f4", 64: "<f8"}.get(bits)
        if dtype is None:
            raise ValueError(f"unsupported float bit depth {bits} in {path!r}")
        y = np.frombuffer(data, dtype=dtype).astype(np.float32)
    elif audio_format == 1:  # PCM
        y = _pcm_to_float(data, bits // 8, path)
    else:
        raise ValueError(
            f"unsupported WAV codec {audio_format:#x} in {path!r} (only PCM "
            "and IEEE-float are supported; convert compressed audio to wav)"
        )
    if n_ch > 1:
        y = y[: len(y) - len(y) % n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(y, dtype=np.float32), int(rate)


def _load_flac(path: str) -> Tuple[np.ndarray, int]:
    """FLAC decode via the from-scratch native decoder (audio_io.cpp).

    Real CommonVoice-style corpora ship compressed audio; the reference
    reads them through torchaudio (utils/audio.py:7-9)."""
    lib = _load_native()
    if lib is None:
        raise ValueError(
            f"cannot decode FLAC {path!r}: native audio library unavailable "
            "(g++ build failed?); convert to wav or .npy"
        )
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    p = path.encode()
    if lib.flac_probe(p, ctypes.byref(n), ctypes.byref(sr)) != 0:
        raise ValueError(f"malformed FLAC stream: {path!r}")
    out = np.empty(n.value, np.float32)
    got = lib.flac_decode(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          n.value)
    if got < 0:
        raise ValueError(f"FLAC decode failed: {path!r}")
    return out, sr.value


_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11  # informational: output format announced


@functools.lru_cache(maxsize=None)
def _load_mpg123_lib():
    """libmpg123 (a system library, like the reference's sox binary) for mp3."""
    lib = ctypes.CDLL("libmpg123.so.0")
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    return lib


class _VorbisInfo(ctypes.Structure):
    # leading fields of vorbis_info (codec.h) — all we read
    _fields_ = [("version", ctypes.c_int), ("channels", ctypes.c_int),
                ("rate", ctypes.c_long)]


@functools.lru_cache(maxsize=None)
def _load_vorbisfile():
    """libvorbisfile (a system library, like libmpg123 for mp3) for ogg."""
    lib = ctypes.CDLL("libvorbisfile.so.3")
    lib.ov_fopen.restype = ctypes.c_int
    lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ov_read.restype = ctypes.c_long
    lib.ov_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int)]
    lib.ov_pcm_total.restype = ctypes.c_int64
    lib.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ov_clear.argtypes = [ctypes.c_void_p]
    return lib


# OggVorbis_File is ~944 bytes on 64-bit; we allocate it (opaque) with slack
_OV_FILE_SIZE = 4096


def _load_ogg(path: str) -> Tuple[np.ndarray, int]:
    lib = _load_vorbisfile()
    vf = ctypes.create_string_buffer(_OV_FILE_SIZE)
    rc = lib.ov_fopen(path.encode(), vf)
    if rc != 0:
        raise ValueError(f"malformed ogg/vorbis stream ({rc}): {path!r}")
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise ValueError(f"ogg stream without vorbis info: {path!r}")
        channels = info.contents.channels
        rate = int(info.contents.rate)
        chunks = []
        buf = ctypes.create_string_buffer(1 << 16)
        bs = ctypes.c_int()
        while True:
            n = lib.ov_read(vf, buf, len(buf), 0, 2, 1, ctypes.byref(bs))
            if n == 0:
                break
            if n < 0:
                raise ValueError(f"ogg decode error {n} in {path!r}")
            chunks.append(np.frombuffer(buf.raw[:n], "<i2")
                          .astype(np.float32) / 32768.0)
    finally:
        lib.ov_clear(vf)
    if not chunks:
        return np.zeros(0, np.float32), rate
    y = np.concatenate(chunks)
    if channels > 1:
        y = y[: len(y) - len(y) % channels].reshape(
            -1, channels).mean(axis=1)
    return np.ascontiguousarray(y, np.float32), rate


def _ogg_duration(path: str) -> float:
    lib = _load_vorbisfile()
    vf = ctypes.create_string_buffer(_OV_FILE_SIZE)
    if lib.ov_fopen(path.encode(), vf) != 0:
        raise ValueError(f"malformed ogg/vorbis stream: {path!r}")
    try:
        info = lib.ov_info(vf, -1)
        total = lib.ov_pcm_total(vf, -1)
        rate = info.contents.rate if info else 0
        return total / max(rate, 1)
    finally:
        lib.ov_clear(vf)


def _load_mp3(path: str) -> Tuple[np.ndarray, int]:
    lib = _load_mpg123_lib()
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(f"mpg123 handle failed ({err.value}) for {path!r}")
    try:
        if lib.mpg123_open(h, path.encode()) != 0:
            raise ValueError(f"cannot open mp3: {path!r}")
        rate = ctypes.c_long()
        channels = ctypes.c_int()
        enc = ctypes.c_int()
        lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                             ctypes.byref(enc))
        # lock the output to float32 BEFORE the stream starts decoding
        # (format changes after the first read are ignored): probe pass
        # above fixed rate/channels, reopen with only float32 allowed
        lib.mpg123_close(h)
        lib.mpg123_format_none(h)
        if lib.mpg123_format(h, rate, channels, _MPG123_ENC_FLOAT_32) != 0:
            raise ValueError(f"mpg123 refused float32 output for {path!r}")
        if lib.mpg123_open(h, path.encode()) != 0:
            raise ValueError(f"cannot reopen mp3: {path!r}")
        chunks = []
        buf = ctypes.create_string_buffer(1 << 16)
        done = ctypes.c_size_t()
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value],
                                            np.float32).copy())
            if rc == _MPG123_DONE:
                break
            if rc not in (0, _MPG123_NEW_FORMAT):
                raise ValueError(f"mp3 decode error {rc} in {path!r}")
        lib.mpg123_close(h)
    finally:
        lib.mpg123_delete(h)
    if not chunks:
        return np.zeros(0, np.float32), int(rate.value)
    y = np.concatenate(chunks)
    if channels.value > 1:
        y = y[: len(y) - len(y) % channels.value].reshape(
            -1, channels.value).mean(axis=1)
    return np.ascontiguousarray(y, np.float32), int(rate.value)


def _sniff(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read(4)


def load_audio_with_rate(path: str) -> Tuple[np.ndarray, int]:
    """Decode to float32 mono in [-1, 1], returning (samples, stream rate).

    Containers: PCM/float WAV (native C++ core + numpy fallback), FLAC
    (from-scratch native decoder), mp3 (libmpg123), ogg/vorbis
    (libvorbisfile), ``.npy`` arrays for fixtures (rate reported as 0 =
    unknown). The reference reads all of these through torchaudio
    (utils/audio.py:7-12, channel-mean mixdown)."""
    if path.endswith(".npy"):
        y = np.load(path)
        if y.ndim > 1:
            y = y.mean(axis=-1)
        return y.astype(np.float32), 0
    head = _sniff(path)
    if head == b"fLaC":
        return _load_flac(path)
    if head == b"OggS":
        return _load_ogg(path)
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF
                              and (head[1] & 0xE0) == 0xE0
                              and head[:4] != b"RIFF"):
        return _load_mp3(path)
    decoded = _native_decode(path)
    if decoded is not None:
        return decoded
    try:
        with wave.open(path, "rb") as f:
            n_ch = f.getnchannels()
            width = f.getsampwidth()
            rate = f.getframerate()
            n = f.getnframes()
            raw = f.readframes(n)
    except wave.Error:
        return _load_wav_riff(path)
    y = _pcm_to_float(raw, width, path)
    if n_ch > 1:
        y = y.reshape(-1, n_ch).mean(axis=1)
    return y, int(rate)


def load_audio(path: str, sample_rate: Optional[int] = None) -> np.ndarray:
    """Decode to float32 mono. With ``sample_rate`` given, audio whose
    stream rate differs is resampled to it (linear, like the tempo
    augmenter); without it, the stream's native rate is kept."""
    y, sr = load_audio_with_rate(path)
    if sample_rate and sr and sr != sample_rate:
        y = resample_linear(y, sr / float(sample_rate))
    return y


def get_audio_length(path: str, sample_rate: int = 16000) -> float:
    """Duration in seconds (utils/audio.py:14-18 soxi parity — soxi -D uses
    the stream's OWN rate, so ``sample_rate`` only applies to rateless .npy
    fixtures)."""
    if path.endswith(".npy"):
        return len(np.load(path, mmap_mode="r")) / sample_rate
    head = _sniff(path)
    if head == b"fLaC":
        lib = _load_native()
        n = ctypes.c_int64()
        sr = ctypes.c_int32()
        if lib is not None and lib.flac_probe(path.encode(), ctypes.byref(n),
                                              ctypes.byref(sr)) == 0:
            return n.value / max(sr.value, 1)
        raise ValueError(f"cannot probe FLAC: {path!r}")
    if head == b"OggS":
        return _ogg_duration(path)
    if head[:3] == b"ID3" or (head and head[0] == 0xFF and head[:4] != b"RIFF"
                              and (head[1] & 0xE0) == 0xE0):
        return _mp3_duration(path)
    try:
        with wave.open(path, "rb") as f:
            return f.getnframes() / f.getframerate()
    except wave.Error:
        y, sr = _load_wav_riff(path)  # float/extensible WAV
        return len(y) / max(sr, 1)


def _mp3_duration(path: str) -> float:
    """mp3 duration via mpg123_scan + mpg123_length (frame index scan — no
    full decode) at the stream's own rate; decodes only if the scan API is
    missing."""
    lib = _load_mpg123_lib()
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(f"mpg123 handle failed ({err.value}) for {path!r}")
    try:
        if lib.mpg123_open(h, path.encode()) != 0:
            raise ValueError(f"cannot open mp3: {path!r}")
        rate = ctypes.c_long()
        channels = ctypes.c_int()
        enc = ctypes.c_int()
        lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                             ctypes.byref(enc))
        try:
            lib.mpg123_scan.argtypes = [ctypes.c_void_p]
            lib.mpg123_length.restype = ctypes.c_int64  # off_t, LP64
            lib.mpg123_length.argtypes = [ctypes.c_void_p]
            lib.mpg123_scan(h)  # exact length for VBR streams
            n = lib.mpg123_length(h)
        except AttributeError:
            n = -1
        lib.mpg123_close(h)
    finally:
        lib.mpg123_delete(h)
    if n > 0 and rate.value > 0:
        return n / rate.value
    y, sr = _load_mp3(path)  # last resort: full decode
    return len(y) / max(sr, 1)


def resample_linear(y: np.ndarray, rate: float) -> np.ndarray:
    """Tempo change by factor ``rate`` (>1 = faster = shorter)."""
    n_out = max(1, int(round(len(y) / rate)))
    lib = _load_native()
    if lib is not None and len(y) > 1:
        y32 = np.ascontiguousarray(y, np.float32)
        out = np.empty(n_out, np.float32)
        lib.resample_linear_f32(
            y32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(y32),
            n_out, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    x_old = np.arange(len(y), dtype=np.float64)
    x_new = np.linspace(0, len(y) - 1, n_out)
    return np.interp(x_new, x_old, y).astype(np.float32)


def augment_audio(
    y: np.ndarray,
    rng: np.random.RandomState,
    tempo_range: Tuple[float, float] = (0.85, 1.15),
    gain_range: Tuple[float, float] = (-6.0, 8.0),
) -> np.ndarray:
    """Random tempo + gain perturbation (utils/audio.py:49-61 parity)."""
    tempo = rng.uniform(*tempo_range)
    gain_db = rng.uniform(*gain_range)
    y = resample_linear(y, tempo)
    return (y * (10.0 ** (gain_db / 20.0))).astype(np.float32)


class NoiseInjector:
    """Mix noise-file segments at random SNR (utils/data_loader.py:367-399)."""

    def __init__(
        self,
        noise_dir: str,
        sample_rate: int = 16000,
        noise_levels: Tuple[float, float] = (0.0, 0.5),
    ):
        if not os.path.exists(noise_dir):
            raise IOError(f"Directory doesn't exist: {noise_dir}")
        self.paths = sorted(
            os.path.join(noise_dir, f)
            for f in os.listdir(noise_dir)
            if f.endswith((".wav", ".npy"))
        )
        self.sample_rate = sample_rate
        self.noise_levels = noise_levels

    def inject(self, data: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        noise_path = self.paths[rng.randint(len(self.paths))]
        noise = load_audio(noise_path, self.sample_rate)
        level = rng.uniform(*self.noise_levels)
        if len(noise) < len(data):
            reps = int(np.ceil(len(data) / len(noise)))
            noise = np.tile(noise, reps)
        start = rng.randint(0, len(noise) - len(data) + 1)
        seg = noise[start:start + len(data)]
        noise_energy = np.sqrt(seg.dot(seg) / seg.size) + 1e-12
        data_energy = np.sqrt(data.dot(data) / data.size)
        return (data + level * seg * data_energy / noise_energy).astype(
            np.float32
        )
