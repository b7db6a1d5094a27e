"""The training options of the port against the JAX package: the device
CER, the multi-worker prefetch, augmentation and noise, profiling.

One synthetic 3-task corpus and a directory of noise files serve every
case. ``device_cer`` / ``edit_distance_device`` equal
``mtl_tpu.ops.edit_distance_jax``'s integers; ``resample_linear`` (native
and numpy), ``augment_audio`` and ``NoiseInjector`` equal the JAX
package's on one ``RandomState``; the per-iteration draws of 2 and 4
prefetch workers, augmented and noised, equal JAX's ``fetch_at`` stream.
One JAX ``TrainState`` at step 0, whose config turns on ``--augment``,
``--noise-dir``, ``--prefetch-workers 2``, ``--device-cer`` and
``--profile-dir`` (a resumed run takes its settings from the checkpoint),
is copied into a port checkpoint through ``interop``; both
``meta_transfer_train_main``s continue from it for 9 iterations at f32
(tiny width, dropout 0), and their TRAIN and VALID lines agree. No
prefetch thread outlives the port's ``train()``, whether it ends, stops
early or raises.
"""

import json
import os
import re
import threading
import time
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.cli.asr import meta_transfer_train_main as jax_train_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data import audio as jax_audio
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.ops import edit_distance_jax
from mtl_tpu.train.steps import init_train_state
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import meta_transfer_train_main
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data import audio
from mtl_tpu_torch.data.dataset import SpectrogramDataset
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import adam_state_from_optax, flax_params_to_torch
from mtl_tpu_torch.ops.edit_distance import (compact_ids, device_cer,
                                             edit_distance_device)
from mtl_tpu_torch.train.trainer import MultiWorkerPrefetcher, iteration_rng
from mtl_tpu_torch.utils.checkpoint import save_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 123456  # the trainers' default --seed
ITERATIONS = 9  # the profiler runs iterations 3..8 of both packages


def _write_noise(root):
    """Two noise files: a 16-bit WAV and a .npy array."""
    import struct

    os.makedirs(root)
    rng = np.random.RandomState(11)
    y = rng.uniform(-0.3, 0.3, 5000)
    raw = (y * 32767).astype("<i2").tobytes()
    with open(os.path.join(root, "a.wav"), "wb") as f:
        f.write(struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(raw),
                            b"WAVE", b"fmt ", 16, 1, 1, 16000, 32000, 2, 16,
                            b"data", len(raw)) + raw)
    np.save(os.path.join(root, "b.npy"),
            rng.uniform(-0.2, 0.2, 1200).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("options")
    manifests, labels = make_synthetic_corpus(
        str(tmp / "corpus"), num_tasks=3, utts_per_task=6, max_sec=0.5,
        max_chars=6, seed=9)
    return tmp, manifests, labels, _write_noise(str(tmp / "noise"))


def _tiny_cfg(cfg, manifests, labels, noise):
    m = cfg.model
    # no conv subsampler: after the first update the VGG stack's conv
    # biases make the zero-padded frames constant, and its max-pool's
    # gradient goes to whichever tied element the CPU conv's rounding makes
    # largest, so the two packages' trajectories part for reasons that are
    # not the options under test (the VGG stack has its own parity tests)
    m.feat_extractor = "none"
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 64, 32
    t = cfg.train
    t.k_train = t.k_valid = 2
    t.lr, t.meta_lr = 1e-2, 1e-3
    cfg.audio.augment, cfg.audio.noise_dir = True, noise
    cfg.audio.noise_prob = 0.5
    cfg.data.train_manifest_list, cfg.data.labels_path = manifests, labels
    cfg.data.src_bucket_frames, cfg.data.tgt_bucket_len = (64,), (16,)
    return cfg.finalize()


# -- the device CER -------------------------------------------------------

def _rows(seed, b=6, l=11, vocab=9):
    rng = np.random.RandomState(seed)
    hyp = rng.randint(0, vocab, (b, l)).astype(np.int32)
    gold = rng.randint(0, vocab, (b, l)).astype(np.int32)
    gold[0] = 0  # an empty gold row
    hyp[1] = 2  # a hypothesis of EOS only
    gold[2, 5:] = 0  # PAD-padded gold
    return hyp, gold


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("space_id", [None, 5])
def test_device_cer_matches_jax(seed, space_id):
    """Specials (PAD/SOS/EOS/OOV) and the space dropped, empty rows,
    exact integers."""
    hyp, gold = _rows(seed)
    got = device_cer(torch.from_numpy(hyp).long(),
                     torch.from_numpy(gold).long(), space_id=space_id)
    want = edit_distance_jax.device_cer(jnp.asarray(hyp), jnp.asarray(gold),
                                        space_id=space_id)
    assert [int(x) for x in got] == [int(x) for x in want]
    c, n = compact_ids(torch.from_numpy(hyp).long(), [0, 1, 2, 3])
    jc, jn = edit_distance_jax.compact_ids(jnp.asarray(hyp), [0, 1, 2, 3])
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_edit_distance_device_unequal_lengths_match_jax():
    hyp, gold = _rows(3, b=8, l=9)
    gold = gold[:, :6]
    rng = np.random.RandomState(4)
    hl, gl = rng.randint(0, 10, 8), rng.randint(0, 7, 8)
    hl[0], gl[1] = 0, 0
    got = edit_distance_device(torch.from_numpy(hyp), torch.from_numpy(hl),
                               torch.from_numpy(gold), torch.from_numpy(gl))
    want = edit_distance_jax.edit_distance_device(hyp, hl, gold, gl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- augmentation ---------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_resample_linear_matches_jax(native, monkeypatch):
    y = np.random.RandomState(0).randn(1001).astype(np.float32)
    if not native:
        monkeypatch.setattr(audio, "_load_native", lambda: None)
        monkeypatch.setattr(jax_audio, "_load_native", lambda: None)
    for rate in (0.85, 1.0, 1.137, 2.0):
        got = audio.resample_linear(y, rate)
        np.testing.assert_array_equal(got, jax_audio.resample_linear(y, rate))
        # the native and numpy paths agree to f32 rounding
        x_new = np.linspace(0, len(y) - 1, len(got))
        np.testing.assert_allclose(
            got, np.interp(x_new, np.arange(len(y)), y), atol=1e-6)


def test_augment_and_noise_match_jax(corpus):
    noise = corpus[3]
    y = np.random.RandomState(1).uniform(-0.5, 0.5, 3000).astype(np.float32)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        np.testing.assert_array_equal(audio.augment_audio(y, r1),
                                      jax_audio.augment_audio(y, r2))
    inj = audio.NoiseInjector(noise, 16000, (0.0, 0.5))
    jinj = jax_audio.NoiseInjector(noise, 16000, (0.0, 0.5))
    assert [os.path.basename(p) for p in inj.paths] == ["a.wav", "b.npy"]
    for n in (3000, 800):  # longer and shorter than a noise file
        np.testing.assert_array_equal(inj.inject(y[:n], r1),
                                      jinj.inject(y[:n], r2))
    assert r1.randint(1 << 30) == r2.randint(1 << 30)
    with pytest.raises(IOError, match="doesn't exist"):
        audio.NoiseInjector(os.path.join(noise, "missing"))


@pytest.mark.parametrize("workers", [2, 4])
def test_prefetch_stream_matches_jax(corpus, workers):
    """Iteration i's augmented, noised draw from RandomState((seed *
    1_000_003 + i) % 2**32), handed out in order by N workers: JAX's
    stream, targets bitwise and audio within 1e-6, for any N."""
    _, manifests, labels, noise = corpus
    jcfg = _tiny_cfg(JaxConfig(), manifests, labels, noise)
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    jds = JaxDataset(JaxVocab.from_json(labels), jcfg, manifests,
                     augment=True, is_train=True, seed=SEED)
    ds = SpectrogramDataset(Vocab.from_json(labels), cfg, manifests,
                            augment=True, is_train=True, seed=SEED)
    assert ds.noise_injector is not None
    pf = MultiWorkerPrefetcher(
        lambda i: ds.sample_meta_batch(2, 2, rng=iteration_rng(SEED, i)),
        workers, start=3)
    try:
        for i in range(3, 8):
            want = jds.sample_meta_batch(2, 2, rng=np.random.RandomState(
                (SEED * 1_000_003 + i) % 2 ** 32))
            for got_b, want_b in zip(pf.get(), want):
                assert set(got_b) == set(want_b)
                np.testing.assert_array_equal(got_b["targets"],
                                              want_b["targets"])
                np.testing.assert_array_equal(got_b["audio_lengths"],
                                              want_b["audio_lengths"])
                np.testing.assert_allclose(got_b["audio"], want_b["audio"],
                                           atol=1e-6, rtol=0)
    finally:
        pf.stop()
    assert not any(t.name.startswith("prefetch") and t.is_alive()
                   for t in pf.pool._threads)


def test_prefetcher_stop_leaves_no_thread_running():
    """stop() cancels the queued fetches and waits for the running ones."""
    started = []

    def slow(i):
        started.append(i)
        time.sleep(0.5)
        return i

    pf = MultiWorkerPrefetcher(slow, 3)  # 6 fetches queued, 3 running
    assert pf.get() == 0  # a 7th queued; 3, 4 and 5 start
    pf.stop()
    assert all(not t.is_alive() for t in pf.pool._threads)
    assert 6 not in started  # the queue's tail was cancelled


# -- the CLI with all the options, against JAX ---------------------------

def _iteration_lines(out):
    keep = [ln for ln in out.splitlines() if ln.startswith("(Iteration")]
    return [re.sub(r" TOTAL TIME:.*$", "", ln) for ln in keep]


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("prefetch") and t.is_alive()]


@pytest.fixture(scope="module")
def runs(corpus):
    """Both CLIs from one step-0 state with the options on: (JAX output,
    port output, the port run's profile dir, the prefetch threads alive
    after the port's run)."""
    tmp, manifests, labels, noise = corpus
    old = os.getcwd()
    os.chdir(tmp)  # both CLIs write log/<name>.log
    try:
        cfg = _tiny_cfg(JaxConfig(), manifests, labels, noise)
        t = cfg.train
        t.evaluate_every = t.save_every = ITERATIONS
        t.prefetch_workers, t.device_cer = 2, True
        cfg.name, cfg.save_folder = "init", str(tmp / "models")
        vocab = JaxVocab.from_json(labels)
        example, _ = JaxDataset(vocab, cfg, manifests, is_train=True,
                                seed=0).sample_meta_batch(2, 2)
        tx = optax.adam(t.meta_lr)
        state = init_train_state(
            jax_build_model(cfg, len(vocab)), cfg, tx, jax.random.PRNGKey(3),
            jax.tree.map(lambda x: jnp.asarray(x[0]), example))
        profiles = {}
        paths = {}
        for side in ("jax", "port"):
            profiles[side] = t.profile_dir = str(tmp / f"profile_{side}")
            if side == "jax":
                paths[side] = jax_save_checkpoint(cfg, vocab, state, 0)
            else:
                port_cfg = Config.from_dict(json.loads(cfg.to_json()))
                port_cfg.name = "init_port"
                adam = jax.tree.map(np.asarray, state.opt_state[0])
                paths[side] = save_checkpoint(
                    port_cfg, Vocab.from_dict(vocab.to_dict()),
                    flax_params_to_torch(jax.tree.map(np.asarray,
                                                      state.params)), 0,
                    opt_state=adam_state_from_optax(adam.mu, adam.nu,
                                                    adam.count))
        common = ["--train-manifest-list", *manifests,
                  "--valid-manifest-list", manifests[-1],
                  "--labels-path", labels, "--src-buckets", "64",
                  "--tgt-buckets", "16", "--epochs", str(ITERATIONS)]
        outs = {}
        # the port first: the JAX package's pool threads (also named
        # "prefetch...") outlive its run
        for side, main, extra in (
                ("port", meta_transfer_train_main,
                 ["--name", "port_run", "--device", "cpu"]),
                ("jax", jax_train_main, ["--name", "jax_run"])):
            buf = StringIO()
            with redirect_stdout(buf):
                main(common + extra + ["--continue-from", paths[side]])
            outs[side] = buf.getvalue()
            if side == "port":
                alive = _prefetch_threads()
        yield outs["jax"], outs["port"], profiles["port"], alive
    finally:
        os.chdir(old)


def _parse(line):
    nums = [float(x) for x in re.findall(r"LOSS:(\S+)", line)]
    return re.sub(r"LOSS:\S+", "LOSS:", line), nums


def test_options_cli_lines_match_jax(runs):
    """TRAIN lines (loss within 1e-4 relative at f32, the device CER to
    the printed digit) and the VALID lines of the noised valid set."""
    want, got = _iteration_lines(runs[0]), _iteration_lines(runs[1])
    assert sum("TRAIN LOSS" in ln for ln in want) == ITERATIONS
    assert sum("AVG VALID" in ln for ln in want) == 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        (g_text, g_nums), (w_text, w_nums) = _parse(g), _parse(w)
        assert g_text == w_text
        np.testing.assert_allclose(g_nums, w_nums, rtol=1e-4)


def test_options_cli_profiles_and_stops_its_workers(runs):
    """The port's run wrote a torch.profiler trace that carries the
    program's spans (the meta step and its support backward, one of each a
    traced iteration) and printed the JAX package's line; no prefetch thread
    was alive after it returned."""
    _, port_out, profile_dir, alive = runs
    assert f"PROFILE written to {profile_dir}" in port_out
    traces = [f for f in os.listdir(profile_dir) if f.endswith(".json")]
    assert len(traces) == 1
    with open(os.path.join(profile_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("meta.step") == 5  # iterations 4 to 8
    assert names.count("meta.support_grad") == 5 * 3  # K 3 tasks each
    assert names.count("train.iteration") == 5
    assert alive == []


def _port_argv(corpus, name, extra):
    tmp, manifests, labels, noise = corpus
    return ["--train-manifest-list", *manifests, "--valid-manifest-list",
            manifests[-1], "--labels-path", labels, "--device", "cpu",
            "--num-enc-layers", "1", "--num-dec-layers", "1", "--num-heads",
            "2", "--dim-model", "8", "--dim-key", "4", "--dim-value", "4",
            "--dim-inner", "8", "--dim-emb", "8", "--r", "2", "--dropout",
            "0", "--dtype", "float32", "--src-max-len", "64",
            "--tgt-max-len", "32", "--src-buckets", "64", "--tgt-buckets",
            "16", "--k-train", "2", "--k-valid", "2", "--save-folder",
            str(tmp / "models"), "--name", name, "--prefetch-workers", "4",
            "--augment", "--noise-dir", noise] + extra


def test_no_prefetch_thread_outlives_an_early_stop(corpus, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(corpus[0])
    state = meta_transfer_train_main(_port_argv(corpus, "early", [
        "--epochs", "40", "--evaluate-every", "1", "--save-every", "1",
        "--early-stop", "cer,1", "--device-cer"]))
    out = capsys.readouterr().out
    assert "EARLY STOP" in out and state.step < 40
    assert _prefetch_threads() == []


def test_no_prefetch_thread_outlives_a_failing_run(corpus, monkeypatch,
                                                   capsys):
    """Every draw after the initial one raises: the loop gives up after
    its consecutive-failure cap and re-raises, and the workers are gone."""
    monkeypatch.chdir(corpus[0])
    draw = SpectrogramDataset.sample_meta_batch
    calls = []

    def fail(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:  # the trainer's initial draw
            return draw(self, *args, **kwargs)
        raise RuntimeError("unreadable corpus")

    monkeypatch.setattr(SpectrogramDataset, "sample_meta_batch", fail)
    with pytest.raises(RuntimeError, match="unreadable corpus"):
        meta_transfer_train_main(_port_argv(corpus, "failing", [
            "--epochs", "3"]))
    assert _prefetch_threads() == []
    assert "fetching new data" in capsys.readouterr().out
