"""The port's log-spectrogram front-end against the JAX package's.

The JAX side runs ``log_spectrogram(use_pallas=False, prepadded=True)``:
the Pallas kernel ``stft_logmag_pallas`` has no interpret flag and cannot
run on the CPU, and its XLA twin (mtl_tpu/ops/frontend.py:151-158, two f32
HIGHEST einsums + log1p(sqrt)) computes the same function, so it is the
reference here. The port runs the plain version of its STFT kernel (CPU
tensors). Both sides are f32 on the same numpy batch; tolerances are f32
summation-order ones (1e-4 on the O(1) normalized features, 1e-5 on the
raw log magnitudes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.data.dataset import collate_audio as jax_collate_audio
from mtl_tpu.ops import frontend as jfe
from mtl_tpu_torch.data.dataset import collate_audio
from mtl_tpu_torch.ops import frontend as fe
from mtl_tpu_torch.ops.stft import stft_logmag
from tests.torch_threads import one_torch_thread  # noqa: F401

SR, N_FFT, HOP = 16000, 320, 160


def _batch(lengths, seed=0, n_fft=N_FFT, hop=HOP, bucket=None):
    rng = np.random.RandomState(seed)
    waves = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / SR
        waves.append((0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
                      + 0.05 * rng.randn(n)).astype(np.float32))
    frames = bucket or 1 + max(lengths) // hop
    return waves, collate_audio(waves, [[1]] * len(waves), hop, (frames,),
                                (4,), 4000, n_fft=n_fft)


def test_collate_matches_jax():
    waves, batch = _batch([4000, 2561, 911], bucket=40)
    jb = jax_collate_audio(waves, [[1]] * 3, HOP, (40,), (4,), 4000,
                           n_fft=N_FFT)
    for k in ("audio", "audio_lengths", "targets", "src_percentages"):
        np.testing.assert_array_equal(batch[k], np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("window", ["hamming", "hann", "blackman",
                                    "bartlett"])
def test_dft_matrices_identical(window):
    for a, b in zip(fe.dft_matrices(N_FFT, window),
                    jfe.dft_matrices(N_FFT, window)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_fft,hop,prepadded", [(320, 160, True),
                                                 (320, 160, False),
                                                 (400, 160, True)])
def test_frame_signal_matches_jax(n_fft, hop, prepadded):
    """hop | n_fft (the hop-chunk framing) and hop not dividing n_fft (the
    gather path, right zero pad)."""
    _, batch = _batch([3000, 1234], n_fft=n_fft, hop=hop)
    audio = batch["audio"]
    got = fe.frame_signal(torch.from_numpy(audio), n_fft, hop, prepadded)
    want = np.asarray(jfe.frame_signal(jnp.asarray(audio), n_fft, hop,
                                       prepadded))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# (n_fft, hop) at the 20 ms / 10 ms windows of 16, 22.05, 44.1 and 11.025
# kHz: the FFT route's n_fft and three of the direct route's (ops/stft.py:
# stft_route), whose hops 220, 441 and 110 do not divide n_fft
WINDOWS_AT = [(320, 160), (441, 220), (882, 441), (220, 110)]


@pytest.mark.parametrize("n_fft,hop", WINDOWS_AT)
def test_stft_plain_matches_xla_twin(n_fft, hop):
    """stft_logmag (plain version on the CPU) vs the XLA twin of the Pallas
    kernel on the same frames; f32 at HIGHEST on the JAX side."""
    _, batch = _batch([4000, 2560], n_fft=n_fft, hop=hop)
    audio = batch["audio"]
    cos_b, nsin_b = fe.dft_matrices(n_fft, "hamming")
    frames = jfe.frame_signal(jnp.asarray(audio), n_fft, hop, prepadded=True)
    # 1 + (unpadded samples) // hop frames: at an odd n_fft the last one
    # runs past the row's end, where JAX's gather repeats the last sample
    n_t = frames.shape[1]
    got = stft_logmag(fe.frame_tail(torch.from_numpy(audio), n_fft, hop, n_t),
                      n_fft, hop, n_t, "hamming")
    re = jnp.einsum("btn,nf->btf", frames, cos_b, precision="highest")
    im = jnp.einsum("btn,nf->btf", frames, nsin_b, precision="highest")
    want = np.asarray(jnp.log1p(jnp.sqrt(re * re + im * im)))
    assert got.shape == want.shape == (2, n_t, n_fft // 2 + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop", WINDOWS_AT)
@pytest.mark.parametrize("normalize", [True, False])
def test_log_spectrogram_matches_jax_on_ragged_batch(normalize, n_fft, hop):
    lengths = [4000, 2561, 160]
    _, batch = _batch(lengths, bucket=40, n_fft=n_fft, hop=hop)
    audio, alen = batch["audio"], batch["audio_lengths"]
    feats, flen = fe.log_spectrogram(torch.from_numpy(audio),
                                     torch.from_numpy(alen), n_fft, hop,
                                     normalize=normalize, prepadded=True)
    jfeats, jflen = jfe.log_spectrogram(jnp.asarray(audio), jnp.asarray(alen),
                                        n_fft, hop, normalize=normalize,
                                        use_pallas=False, prepadded=True)
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))
    assert feats.shape == jfeats.shape == (3, 40, n_fft // 2 + 1)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-4,
                               atol=1e-4)
    # padded frames are exact zeros after the normalize
    for i, n in enumerate(flen.tolist()):
        assert not feats[i, n:].any()


@pytest.mark.parametrize("n_fft,hop", WINDOWS_AT)
def test_log_spectrogram_matches_jax_when_a_row_fills_the_batch(n_fft, hop):
    """The longest row ends at the batch's last column, hop dividing its
    sample count: at an odd n_fft (441) the last frame runs one sample past
    the row, which JAX's framing clamps (``frame_tail``)."""
    rng = np.random.RandomState(n_fft)
    s = 20 * hop
    audio = rng.randn(2, s + 2 * (n_fft // 2)).astype(np.float32)
    alen = np.array([s, s // 2], np.int32)
    feats, flen = fe.log_spectrogram(torch.from_numpy(audio),
                                     torch.from_numpy(alen), n_fft, hop,
                                     prepadded=True)
    jfeats, jflen = jfe.log_spectrogram(jnp.asarray(audio), jnp.asarray(alen),
                                        n_fft, hop, use_pallas=False,
                                        prepadded=True)
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))
    assert feats.shape == jfeats.shape == (2, 21, n_fft // 2 + 1)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-4,
                               atol=1e-4)
    frames = fe.frame_signal(torch.from_numpy(audio), n_fft, hop, True)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(
        jfe.frame_signal(jnp.asarray(audio), n_fft, hop, True)))


def test_log_spectrogram_matches_oracle():
    """Each row of the ragged batch against the numpy rFFT oracle (librosa
    center=True semantics, unbiased std); 1e-3 as tests/test_frontend.py."""
    lengths = [4000, 2560]
    waves, batch = _batch(lengths)
    feats, flen = fe.log_spectrogram(torch.from_numpy(batch["audio"]),
                                     torch.from_numpy(batch["audio_lengths"]),
                                     N_FFT, HOP, prepadded=True)
    for i, w in enumerate(waves):
        ref = jfe.log_spectrogram_oracle(w, N_FFT, HOP)
        n = int(flen[i])
        assert n == ref.shape[0] == 1 + lengths[i] // HOP
        np.testing.assert_allclose(feats[i, :n].numpy(), ref, rtol=1e-3,
                                   atol=1e-3)


def test_normalize_per_utterance_matches_jax():
    rng = np.random.RandomState(3)
    spect = rng.rand(3, 12, 7).astype(np.float32)
    flen = np.array([12, 5, 1], np.int32)  # n = 1 row: variance floor
    got = fe.normalize_per_utterance(torch.from_numpy(spect),
                                     torch.from_numpy(flen))
    want = jfe.normalize_per_utterance(jnp.asarray(spect), jnp.asarray(flen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_device_dft_matrices_are_built_once():
    """The served path copies the bases to its device once, not per batch;
    the copies equal the numpy bases exactly."""
    dev = torch.device("cpu")
    first = fe.device_dft_matrices(N_FFT, "hamming", dev)
    assert fe.device_dft_matrices(N_FFT, "hamming", dev) is first
    for got, want in zip(first, fe.dft_matrices(N_FFT, "hamming")):
        assert got.device == dev and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
