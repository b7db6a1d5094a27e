"""The port's sequence-parallel long-form encode (``parallel/sp.py``,
``test_main --mesh-model M``) against the unsharded encode, on the CPU.

* ``encode_sp`` on a 2-rank (model 2) and a 4-rank (data 2 x model 2)
  gloo group equals ``model.encode`` of the whole batch within atol 2e-5
  (tests/test_parallel.py:702 holds the JAX SP encode so): vgg_cnn with
  the Transformer encoder and with a 1-block Conformer, emb_cnn with the
  Transformer, and a 2-block Conformer without a front-end over 4 model
  ranks whose slices (10 frames) are shorter than the depthwise conv's
  halo (15), so the neighbour exchange reaches past the next slice. The
  batch's lengths are ragged and T is no multiple of 4 M. One group of 4
  ranks runs every case (tests/torch_mesh_worker.py).
* ``test_main --mesh-model 2`` on utterances of 3-4 s, past the
  checkpoint's trained cap (src_max_len 64 encoder frames; the CLI raises
  it to 512), prints a PRED/GOLD pair per utterance and finite totals; its
  gathered encoder output equals the unsharded encode of the same batch,
  and its hypotheses the unsharded greedy decode's.
* ``--beam-search`` with ``--mesh-model`` raises.
"""

import math
import re

import numpy as np
import pytest
import torch

from mtl_tpu_torch.config import Config
from mtl_tpu_torch.models.transformer import build_model, init_weights
from mtl_tpu_torch.parallel import launch
from mtl_tpu_torch.parallel.sp import front_end_geometry, time_slices
from tests.torch_mesh_worker import run_encode_cases
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _cfg(feat_extractor, encoder_type, layers=2):
    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = layers, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 512, 32
    m.feat_extractor, m.encoder_type = feat_extractor, encoder_type
    return cfg.finalize()


def _state_dict(cfg, seed):
    """Seeded weights with every bias drawn nonzero."""
    model = build_model(cfg, 20)
    init_weights(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return {k: v.numpy() for k, v in model.state_dict().items()}


# name: (feat_extractor, encoder, encoder layers, T, (data, model))
CASES = {
    "vgg_transformer-m2": ("vgg_cnn", "transformer", 2, 203, (1, 2)),
    "vgg_transformer-d2m2": ("vgg_cnn", "transformer", 2, 203, (2, 2)),
    "vgg_conformer1-m2": ("vgg_cnn", "conformer", 1, 150, (1, 2)),
    "vgg_conformer1-d2m2": ("vgg_cnn", "conformer", 1, 150, (2, 2)),
    "emb_cnn_transformer-d2m2": ("emb_cnn", "transformer", 2, 190, (2, 2)),
    "conformer2-short_slices-m4": ("none", "conformer", 2, 37, (1, 4)),
}


@pytest.fixture(scope="module")
def encoded():
    specs = []
    for i, (fe, enc, layers, t, shape) in enumerate(CASES.values()):
        cfg = _cfg(fe, enc, layers)
        rng = np.random.RandomState(i)
        specs.append({
            "shape": shape, "cfg": cfg.to_json(), "vocab_size": 20,
            "state_dict": _state_dict(cfg, i),
            "features": rng.randn(4, t, cfg.audio.num_freq).astype(
                np.float32),
            "lengths": np.array([t, t - 7, t // 2, t - 21], np.int32)})
    cfg = Config()
    cfg.mesh.data = 4
    got = launch.run(cfg, CPU, run_encode_cases, specs)
    return dict(zip(CASES, got))


@pytest.mark.parametrize("name", list(CASES))
def test_encode_sp_equals_the_unsharded_encode(encoded, name):
    got = encoded[name]
    assert got["sp"].shape == got["plain"].shape
    np.testing.assert_allclose(got["sp"], got["plain"], rtol=0, atol=2e-5)
    m = CASES[name][4][1]
    sizes = [b - a for a, b in got["slices"]]
    assert len(sizes) == m and sizes[0] == max(sizes)
    if name.endswith("short_slices-m4"):
        assert max(sizes) < 15  # the depthwise conv's halo


def test_front_end_halo_and_slices():
    """The halo rule: output frame j of the front-end reads input frames
    [S j + lo, S j + hi]; the halos are the least multiples of S that cover
    them."""
    assert front_end_geometry("vgg_cnn") == (4, 8, 8)
    assert front_end_geometry("large_cnn") == (4, 8, 8)
    assert front_end_geometry("emb_cnn") == (2, 10, 20)
    assert front_end_geometry("none") == (1, 0, 0)
    assert time_slices(50, 2) == [(0, 25), (25, 50)]
    assert time_slices(37, 4) == [(0, 10), (10, 20), (20, 30), (30, 37)]
    with pytest.raises(ValueError, match="empty slice"):
        time_slices(5, 4)


@pytest.fixture(scope="module")
def longform(tmp_path_factory):
    """A seeded port checkpoint trained for 64 encoder frames and a test
    manifest of 3-4 s utterances (300-400 frames, 75-100 encoder
    frames)."""
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("sp_cli")
    manifests, labels = make_synthetic_corpus(
        str(tmp / "corpus"), num_tasks=1, utts_per_task=3, min_sec=3.0,
        max_sec=4.0, max_chars=6, seed=4)
    vocab = Vocab.from_json(labels)
    cfg = _cfg("vgg_cnn", "transformer")
    cfg.model.src_max_len = 64
    cfg.data.labels_path, cfg.name = labels, "sp_ckpt"
    cfg.save_folder = str(tmp / "models")
    model = build_model(cfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(0))
    path = save_checkpoint(cfg, vocab, model.state_dict(), 0)
    return tmp, manifests[0], labels, path


def _sp_argv(longform, *extra):
    _, manifest, labels, path = longform
    return ["--test-manifest-list", manifest, "--labels-path", labels,
            "--continue-from", path, "--k-test", "2", "--src-buckets",
            "512", "--tgt-buckets", "16", "--src-max-len", "512",
            "--device", "cpu", "--name", "sp_test", *extra]


def test_test_main_sequence_parallel_longform(longform, monkeypatch,
                                              capsys):
    from mtl_tpu_torch.cli import asr
    from mtl_tpu_torch.cli.common import load_asr_model
    from mtl_tpu_torch.decode.greedy import greedy_search
    from mtl_tpu_torch.parallel import sp
    from mtl_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.chdir(longform[0])
    calls, encs = [], []
    real_search, real_gather = asr.greedy_search_sp, sp.gather_encoder_output

    def search(model, features, lengths, *args):
        hyps = real_search(model, features, lengths, *args)
        calls.append((features, lengths, hyps))
        return hyps

    def gather(*args):
        enc = real_gather(*args)
        encs.append(enc)
        return enc

    monkeypatch.setattr(asr, "greedy_search_sp", search)
    monkeypatch.setattr(sp, "gather_encoder_output", gather)
    result = asr.test_main(_sp_argv(longform, "--mesh-model", "2"))
    out = capsys.readouterr().out
    assert "sequence-parallel encode: time axis over model=2 " \
           "(src_max_len=512)" in out
    assert result["utterances"] == 3 and len(re.findall("PRED:", out)) == 3
    assert all(math.isfinite(result[k]) for k in ("cer", "wer"))
    assert len(calls) == len(encs) == 2  # batches of 2: one padded

    saved_cfg, vocab, state_dict, _, _ = load_checkpoint(longform[3])
    saved_cfg.model.src_max_len = 512
    model = load_asr_model(saved_cfg, vocab, state_dict, CPU)
    for (features, lengths, hyps), enc in zip(calls, encs):
        assert features.shape[1] // 4 > 64  # past the trained cap
        with torch.no_grad():
            want = model.encode(features, lengths)
        torch.testing.assert_close(enc, want, rtol=0, atol=2e-5)
        assert hyps == greedy_search(model, features, lengths, vocab, 300,
                                     vocab.SOS_ID)


def test_test_main_sequence_parallel_refuses_beam_search(longform):
    from mtl_tpu_torch.cli.asr import test_main

    with pytest.raises(ValueError, match="greedy decode only"):
        test_main(_sp_argv(longform, "--mesh-model", "2", "--beam-search"))
