"""The port's audio codecs and its host C++ cores against the JAX package.

FLAC (the native core's decoder, ``csrc/host/audio_io.cpp``) and
ogg/vorbis (the system libvorbisfile) decode, and their durations, equal
the JAX loader's on fixtures written by libsndfile (the helper of
tests/test_utils_misc.py, copied; skipped where absent, as there); mp3
(the system libmpg123) on a fixture written by libmp3lame. Corrupt
streams raise the JAX loader's exceptions with its messages. The native
edit-distance core gives JAX's ``distance_batch``. Both packages build
their own copies of the C++ sources (the port into ``build/host/``).
"""

import ctypes
import glob
import importlib.util
import os
import struct

import numpy as np
import pytest

from mtl_tpu.data import audio as jax_audio
from mtl_tpu.utils.edit_distance import distance_batch as jax_distance_batch
from mtl_tpu_torch.data import audio
from mtl_tpu_torch.utils import host_native
from mtl_tpu_torch.utils.edit_distance import (_codes, _np_distance,
                                               distance, distance_batch)
from tests.torch_threads import one_torch_thread  # noqa: F401

RATE = 16000


def _write_sndfile(path, pcm16, n_ch, rate, fmt_code):
    """Encode a fixture via libsndfile (bundled with the pygame wheel, in
    ``pygame.libs`` beside the package), a test-only dependency
    (tests/test_utils_misc.py:_write_sndfile)."""
    spec = importlib.util.find_spec("pygame")
    libdir = os.path.join(os.path.dirname(os.path.dirname(spec.origin)),
                          "pygame.libs") if spec and spec.origin else ""
    cands = glob.glob(f"{libdir}/libsndfile*") if libdir else []
    if not cands:
        pytest.skip("no libsndfile available to write FLAC/ogg fixtures")
    # libsndfile's bundled codec deps carry mangled sonames; preload only
    # those (a blanket preload would also inject pygame's second libmpg123)
    for name in ("libogg", "libvorbis-", "libvorbisenc", "libFLAC",
                 "libopus-", "libopusfile"):
        for dep in glob.glob(f"{libdir}/{name}*"):
            try:
                ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
            except OSError:
                pass
    sf = ctypes.CDLL(cands[0])

    class SFInfo(ctypes.Structure):
        _fields_ = [("frames", ctypes.c_int64),
                    ("samplerate", ctypes.c_int),
                    ("channels", ctypes.c_int),
                    ("format", ctypes.c_int),
                    ("sections", ctypes.c_int),
                    ("seekable", ctypes.c_int)]

    sf.sf_open.restype = ctypes.c_void_p
    sf.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                           ctypes.POINTER(SFInfo)]
    sf.sf_write_short.restype = ctypes.c_int64
    sf.sf_write_short.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int16),
                                  ctypes.c_int64]
    sf.sf_close.argtypes = [ctypes.c_void_p]
    info = SFInfo(0, rate, n_ch, fmt_code, 0, 0)
    h = sf.sf_open(path.encode(), 0x20, ctypes.byref(info))  # SFM_WRITE
    assert h, f"libsndfile failed to open {path} for writing"
    data = np.ascontiguousarray(pcm16, np.int16)
    n = sf.sf_write_short(h, data.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int16)), len(data))
    sf.sf_close(h)
    assert n == len(data)


def _pcm(n_ch, n=2000, seed=3):
    rng = np.random.RandomState(seed)
    return (np.clip(rng.randn(n * n_ch) * 0.25, -1, 1) * 32767).astype(
        np.int16)


def _write_mp3(path, n=16000):
    try:
        lame = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        pytest.skip("no libmp3lame to write mp3 fixtures")
    sig = 0.5 * np.sin(2 * np.pi * 440 * np.arange(n) / RATE)
    pcm = (sig * 32767).astype(np.int16)
    lame.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_mode", "lame_init_params", "lame_close"):
        getattr(lame, fn).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if fn.startswith("lame_set") else [])
    lame.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    lame.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    g = lame.lame_init()
    lame.lame_set_in_samplerate(g, RATE)
    lame.lame_set_num_channels(g, 1)
    lame.lame_set_mode(g, 3)  # mono
    assert lame.lame_init_params(g) >= 0
    size = int(1.25 * n + 7200)
    out, out2 = (ctypes.create_string_buffer(size) for _ in range(2))
    p16 = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    n1 = lame.lame_encode_buffer(g, p16, p16, n, out, size)
    n2 = lame.lame_encode_flush(g, out2, size)
    lame.lame_close(g)
    with open(path, "wb") as f:
        f.write(out.raw[:n1] + out2.raw[:n2])


@pytest.mark.parametrize("codec,fmt_code", [
    ("flac", 0x170000 | 0x0002),  # FLAC | PCM16
    ("ogg", 0x200000 | 0x0060),   # OGG | VORBIS
])
@pytest.mark.parametrize("n_ch", [1, 2])
def test_flac_and_ogg_decode_as_jax(tmp_path, codec, fmt_code, n_ch):
    path = str(tmp_path / f"x{n_ch}.{codec}")
    _write_sndfile(path, _pcm(n_ch), n_ch, RATE, fmt_code)
    got, rate = audio.load_audio_with_rate(path)
    want, want_rate = jax_audio.load_audio_with_rate(path)
    assert rate == want_rate == RATE and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) == 2000 or codec == "ogg"
    assert audio.get_audio_length(path) == jax_audio.get_audio_length(path)
    # resampled on load as JAX resamples
    np.testing.assert_array_equal(audio.load_audio(path, 8000),
                                  jax_audio.load_audio(path, 8000))


def test_mp3_decode_as_jax(tmp_path):
    path = str(tmp_path / "tone.mp3")
    _write_mp3(path)
    got, rate = audio.load_audio_with_rate(path)
    want, want_rate = jax_audio.load_audio_with_rate(path)
    assert rate == want_rate == RATE and len(got) > 14000
    np.testing.assert_array_equal(got, want)
    assert audio.get_audio_length(path) == jax_audio.get_audio_length(path)


def _wav(path, y, rate=RATE):
    raw = (np.clip(y, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(raw), b"WAVE",
                      b"fmt ", 16, 1, 1, rate, rate * 2, 2, 16, b"data",
                      len(raw))
    with open(path, "wb") as f:
        f.write(hdr + raw)


@pytest.mark.parametrize("head", [
    b"fLaC\x00\x00\x00\x22", b"OggS\x00\x02garbage", b"ID3\x04\x00\x00",
    b"\xff\xfb\x90\x00", b"RIFX\x00\x00\x00\x00WAVE", b"RIFF\x10\x00\x00"
    b"\x00WAVEfmt "])
def test_corrupt_streams_raise_as_jax(tmp_path, head):
    """A corrupt FLAC, ogg, mp3 or WAV stream: both loaders raise the same
    exception with the same message (the path the same), or both return
    the same samples."""
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(head + bytes(range(64)))
    outcomes = []
    for load in (audio.load_audio_with_rate, jax_audio.load_audio_with_rate):
        try:
            y, rate = load(path)
            outcomes.append(("ok", y.tolist(), rate))
        except Exception as e:  # a truncated WAV raises wave's EOFError
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


def test_wav_falls_back_to_numpy_without_the_library(tmp_path, monkeypatch):
    """WAV decodes through the native core, or through numpy when it is
    absent, to the same samples; FLAC then raises JAX's ValueError."""
    path = str(tmp_path / "x.wav")
    _wav(path, np.random.RandomState(0).uniform(-0.5, 0.5, 3000))
    native = audio.load_audio_with_rate(path)
    assert audio._load_native() is not None
    monkeypatch.setattr(audio, "_load_native", lambda: None)
    fallback = audio.load_audio_with_rate(path)
    np.testing.assert_array_equal(native[0], fallback[0])
    assert native[1] == fallback[1] == RATE
    flac = str(tmp_path / "x.flac")
    with open(flac, "wb") as f:
        f.write(b"fLaC" + bytes(40))
    with pytest.raises(ValueError, match="native audio library unavailable"):
        audio.load_audio_with_rate(flac)


def test_host_libraries_build_into_the_build_tree():
    """The port builds its own copies under build/host/, never native/."""
    for name in ("audio_io", "edit_distance"):
        assert host_native.load(name) is not None
        path = host_native.so_path(name)
        assert os.path.exists(path)
        assert os.sep + os.path.join("build", "host") + os.sep in path
        assert os.path.dirname(host_native.SRC_DIR).endswith(
            os.path.join("mtl_tpu_torch", "csrc"))


def test_native_edit_distance_matches_jax():
    rng = np.random.RandomState(0)
    alphabet = "abc de中文f"
    pairs = [("", ""), ("", "abc"), ("kitten", "sitting"), ("中文", "中")]
    pairs += [("".join(rng.choice(list(alphabet), rng.randint(0, 12))),
               "".join(rng.choice(list(alphabet), rng.randint(0, 12))))
              for _ in range(40)]
    got = distance_batch(pairs)
    assert got == jax_distance_batch(pairs)
    assert got == [distance(a, b) for a, b in pairs]
    assert got == [_np_distance(_codes(a), _codes(b)) for a, b in pairs]


def test_host_library_name_follows_the_cpu(monkeypatch):
    """audio_io is built with -march=native: a build made on a CPU with
    other feature flags has another name, so it is never loaded here."""
    here = host_native.so_path("audio_io")
    monkeypatch.setattr(host_native, "_cpu_flags", lambda: "flags : fpu sse2")
    there = host_native.so_path("audio_io")
    assert there != here
    assert os.path.dirname(there) == os.path.dirname(here)
