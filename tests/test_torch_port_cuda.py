"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. On such a
machine, where JAX may be absent, run them without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Shapes cover ragged time and freq tiles (odd T and F, T not a multiple of
16), both channel configurations (vgg_cnn 64/128, large_cnn 32/64), the
flagship shapes, both routes of the STFT, which n_fft chooses (every FFT
radix, an odd FFT half, T = 1, a waveform short of its last frame), and
both routes of the VGG blocks, which ``out_dtype`` chooses, the VGG
stack's autograd Function on both routes, one flagship-width meta step
with its launch counts, the beam's bank and the LM scorer (TF32 allowed
globally) against the CPU, and the beam ``test_main``'s launches.
Tolerances:
both STFT routes are f32 against the f32 plain version; the FFT and the
GEMM sum in other orders (rtol/atol 1e-4). The VGG f32 route differs from
the f32 plain version only in summation order (rtol/atol 1e-4). The bf16
tensor-core route and the bf16-operand plain version sum in f32 in other
orders, so a conv-1 value or an output near a bf16 rounding boundary may
round to its neighbour: one bf16 ulp of the output, |d| <= 2^-7 |plain| +
2^-10 (the absolute term for outputs near zero, where a neighbouring conv-1
value moves the sum by about 1e-4). The beam at f32: equal bank tokens,
lengths and word counts, raw scores (sums of f32 log-probabilities,
summation order only) within 1e-4; LM scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from mtl_tpu_torch.ops import native
from mtl_tpu_torch.ops.frontend import dft_matrices
from mtl_tpu_torch.ops.stft import (stft_logmag, stft_logmag_direct,
                                    stft_logmag_plain, stft_route)
from mtl_tpu_torch.ops.vgg import vgg_block1, vgg_block2, vgg_block_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.build()
    return torch.device("cuda")


def _close_bf16(k, p):
    k, p = k.float(), p.float()
    err = (k - p).abs()
    assert bool((err <= 2.0 ** -7 * p.abs() + 2.0 ** -10).all()), \
        float(err.max())


def _vgg_inputs(dev, shape, cin, c, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    if cin > 1:
        x = x.to(dtype)
    ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32)).to(dev)
          for s, sc in (((3, 3, cin, c), 0.3 / cin ** 0.5), ((c,), 0.1),
                        ((3, 3, c, c), 0.3 / c ** 0.5), ((c,), 0.1))]
    return x, ws


def _run_route(fn, x, ws, dtype, block):
    """One wrapper call; asserts that exactly its dtype's route launched."""
    name = f"vgg_block{block}"
    mine, other = ((name, f"{name}_f32") if dtype == torch.bfloat16
                   else (f"{name}_f32", name))
    before = dict(native.launch_counts)
    out = fn(x, *ws, out_dtype=dtype)
    torch.cuda.synchronize()
    assert native.launch_counts[mine] == before[mine] + 1
    assert native.launch_counts[other] == before[other]
    return out


# (b, t, n_fft, hop, samples short of (t - 1) * hop + n_fft); the FFT
# route's CTAs take 4 frames, so t = 37, 21, 33 and 50 leave a ragged last
# CTA
STFT_SHAPES = [(2, 37, 320, 160, 0), (3, 200, 320, 160, 0),
               (1, 50, 400, 160, 0), (8, 800, 320, 160, 0),
               (2, 33, 160, 80, 0), (3, 1, 320, 160, 0),
               (2, 21, 320, 160, 250), (1, 9, 480, 160, 0),
               (1, 7, 512, 160, 0), (1, 12, 250, 100, 0),
               (1, 40, 448, 160, 0)]


def _stft_inputs(dev, b, t, n_fft, hop, short):
    rng = np.random.RandomState(t + n_fft)
    s = (t - 1) * hop + n_fft - short
    audio = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (b, s)).astype(np.float32)).to(dev)
    cos_b, nsin_b = (torch.from_numpy(m).to(dev)
                     for m in dft_matrices(n_fft, "hamming"))
    return audio, cos_b, nsin_b


@pytest.mark.parametrize("b,t,n_fft,hop,short", STFT_SHAPES)
def test_stft_kernel_matches_plain(dev, b, t, n_fft, hop, short):
    """The wrapper launches the route its n_fft picks (the FFT for 448's
    factor 7 is refused: the direct kernel), and only that one."""
    audio, cos_b, nsin_b = _stft_inputs(dev, b, t, n_fft, hop, short)
    mine, other = (("stft_logmag", "stft_logmag_direct")
                   if stft_route(n_fft) == "fft"
                   else ("stft_logmag_direct", "stft_logmag"))
    assert (mine == "stft_logmag") == (n_fft != 448)
    before = dict(native.launch_counts)
    out = stft_logmag(audio, n_fft, hop, t, "hamming")
    torch.cuda.synchronize()
    assert native.launch_counts[mine] == before[mine] + 1
    assert native.launch_counts[other] == before[other]
    ref = stft_logmag_plain(audio, cos_b, nsin_b, t, hop)
    assert out.shape == ref.shape == (b, t, n_fft // 2 + 1)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t,n_fft,hop,short", STFT_SHAPES)
def test_stft_direct_route_matches_plain(dev, b, t, n_fft, hop, short):
    """The direct kernel takes every n_fft through its launcher."""
    audio, cos_b, nsin_b = _stft_inputs(dev, b, t, n_fft, hop, short)
    before = native.launch_counts["stft_logmag_direct"]
    out = stft_logmag_direct(audio, cos_b, nsin_b, t, hop)
    torch.cuda.synchronize()
    assert native.launch_counts["stft_logmag_direct"] == before + 1
    ref = stft_logmag_plain(audio, cos_b, nsin_b, t, hop)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_stft_fft_library_refused_raises(dev, monkeypatch):
    """When the FFT library cannot be had, an n_fft of the FFT route
    raises; it does not run the direct kernel or the plain version."""
    real = native.library

    def refuse(name):
        if name == "stft_fft":
            raise RuntimeError("stft_fft refused")
        return real(name)

    monkeypatch.setattr(native, "library", refuse)
    audio, _, _ = _stft_inputs(dev, 1, 5, 320, 160, 0)
    before = dict(native.launch_counts)
    with pytest.raises(RuntimeError, match="stft_fft refused"):
        stft_logmag(audio, 320, 160, 5)
    assert native.launch_counts == before


@pytest.mark.parametrize("t,f", [(16, 13), (37, 161), (100, 161)])
@pytest.mark.parametrize("cin,c", [(1, 64), (1, 32), (64, 128), (32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_kernel_matches_plain(dev, t, f, cin, c, dtype):
    """f32: the f32 CUDA-core route against the f32 plain version; bf16:
    the tensor-core route against the bf16-operand plain version."""
    shape = (2, t, f) if cin == 1 else (2, t, f, cin)
    x, ws = _vgg_inputs(dev, shape, cin, c, dtype, t + c)
    fn, block = (vgg_block1, 1) if cin == 1 else (vgg_block2, 2)
    out = _run_route(fn, x, ws, dtype, block)
    ref = vgg_block_plain(x, *ws, out_dtype=dtype)
    assert out.shape == ref.shape == (2, t // 2, f // 2, c)
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("block", [1, 2])
def test_vgg_tc_flagship_tiles(dev, block):
    """The flagship shapes (batch 8, 800 frames x 161 bins; block 2 at
    400 x 80 x 64): many tiles in both axes, block 1's odd F, and the
    persistent block-1 grid walking several tiles per CTA."""
    if block == 1:
        x, ws = _vgg_inputs(dev, (8, 800, 161), 1, 64, torch.bfloat16, 1)
        fn = vgg_block1
    else:
        x, ws = _vgg_inputs(dev, (8, 400, 80, 64), 64, 128, torch.bfloat16,
                            2)
        x = x.relu()  # like block 1's output
        fn = vgg_block2
    out = _run_route(fn, x, ws, torch.bfloat16, block)
    ref = vgg_block_plain(x, *ws, out_dtype=torch.bfloat16)
    assert out.shape == ref.shape
    _close_bf16(out, ref)


def test_vgg_tc_refuses_unbuilt_channels(dev):
    """C = 16 has no kernel: a bf16 CUDA call raises ValueError and neither
    route launches."""
    x, ws = _vgg_inputs(dev, (1, 16, 13), 1, 16, torch.bfloat16, 3)
    before = dict(native.launch_counts)
    with pytest.raises(ValueError):
        vgg_block1(x, *ws, out_dtype=torch.bfloat16)
    assert native.launch_counts == before


def test_vgg_tc_library_refused_raises(dev, monkeypatch):
    """When the tensor-core library cannot be had, a bf16 CUDA call raises;
    it does not run the f32 route or the plain version instead."""
    real = native.library

    def refuse(name):
        if name == "vgg_tc":
            raise RuntimeError("vgg_tc refused")
        return real(name)

    monkeypatch.setattr(native, "library", refuse)
    for cin, c, fn in ((1, 64, vgg_block1), (64, 128, vgg_block2)):
        shape = (1, 16, 13) if cin == 1 else (1, 16, 13, cin)
        x, ws = _vgg_inputs(dev, shape, cin, c, torch.bfloat16, 4)
        before = dict(native.launch_counts)
        with pytest.raises(RuntimeError, match="vgg_tc refused"):
            fn(x, *ws, out_dtype=torch.bfloat16)
        assert native.launch_counts == before


# -- the VGG stack's autograd Function and the meta step ------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_stack_grads_match_plain_autograd(dev, dtype):
    """The Function (kernels forward, recomputed plain VJP backward)
    against autograd through the route's plain version on the card (TF32
    off, as the Function's backward runs it) on a short batch: the same
    computation up to the order of cuDNN's sums (its weight-gradient
    algorithms are not deterministic). f32: rtol 1e-3 and 1e-3 of the
    largest entry. bf16: the bf16-operand form rounds the gradient that
    reaches each conv to bf16, and a value on a rounding boundary may round
    either way, moving a weight gradient by one bf16 ulp of one of its
    terms; rtol 2^-7 and 2^-6 of the largest entry."""
    from mtl_tpu_torch.ops.vgg import vgg_stack, vgg_stack_plain

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 64, 161).astype(np.float32)).to(dev)
    ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32)).to(dev)
          for s, sc in (((3, 3, 1, 64), 0.3), ((64,), 0.1),
                        ((3, 3, 64, 64), 0.04), ((64,), 0.1),
                        ((3, 3, 64, 128), 0.04), ((128,), 0.1),
                        ((3, 3, 128, 128), 0.03), ((128,), 0.1))]
    g = torch.from_numpy(rng.randn(2, 16, 40 * 128).astype(np.float32)).to(
        dev).to(dtype)
    w1 = [w.clone().requires_grad_(True) for w in ws]
    before = native.launch_counts["vgg_stack_bwd"]
    got = torch.autograd.grad(vgg_stack(x, w1, out_dtype=dtype), w1, g)
    torch.cuda.synchronize()
    assert native.launch_counts["vgg_stack_bwd"] == before + 1
    w2 = [w.clone().requires_grad_(True) for w in ws]
    want = torch.autograd.grad(vgg_stack_plain(x, w2, dtype), w2, g)
    rtol, scale = ((1e-3, 1e-3) if dtype == torch.float32
                   else (2.0 ** -7, 2.0 ** -6))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=scale * float(b.abs().max()))


def test_flagship_meta_step_launches_the_kernels(dev, tmp_path):
    """One bf16 meta step at the flagship width (3 tasks of 8 + 8
    utterances, 800 frames): every support and query forward runs both
    tensor-core VGG kernels and the FFT STFT, every backward the stack's
    recompute; the loss is finite and the weights move."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    manifests, labels = make_synthetic_corpus(
        str(tmp_path), num_tasks=3, utts_per_task=8, min_sec=4.0,
        max_sec=7.9, seed=1)
    vocab = Vocab.from_json(labels)
    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 4, 8
    m.dim_inner, m.dropout = 512, 0.1
    cfg.data.src_bucket_frames = (800,)
    cfg.finalize()
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=0)
    support, query = ds.sample_meta_batch(8, 8)
    assert support["audio"].shape[:2] == (3, 8)
    model = build_model(cfg, len(vocab), dev)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(1e-4)
    state = init_train_state(model, opt)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    native.reset_launch_counts()
    state, metrics = make_meta_step(model, cfg, opt)(
        state, batch_to_device(support, dev), batch_to_device(query, dev),
        torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    c = native.launch_counts
    assert c["vgg_block1"] == c["vgg_block2"] == c["vgg_stack_bwd"] == 6, c
    assert c["stft_logmag"] == 4 and c["stft_logmag_direct"] == 0, c
    assert c["vgg_block1_f32"] == c["vgg_block2_f32"] == 0, c
    assert torch.isfinite(metrics["outer_loss"])
    moved = sum(int((state.params[k] != v).sum()) for k, v in before.items())
    assert moved > 0.5 * sum(v.numel() for v in before.values())


def test_vgg_stack_forward_raises_instead_of_falling_back(dev, monkeypatch):
    """A kernel that cannot be had makes the stack's forward (and so the
    model's) raise; nothing runs the plain version in its place."""
    from mtl_tpu_torch.ops.vgg import vgg_stack

    real = native.library

    def refuse(name):
        if name in ("vgg_tc", "vgg"):
            raise RuntimeError(f"{name} refused")
        return real(name)

    monkeypatch.setattr(native, "library", refuse)
    x, ws1 = _vgg_inputs(dev, (1, 16, 13), 1, 64, torch.float32, 6)
    _, ws2 = _vgg_inputs(dev, (1, 8, 6, 64), 64, 128, torch.float32, 7)
    ws = [w.requires_grad_(True) for w in ws1 + ws2]
    for dtype in (torch.bfloat16, torch.float32):
        before = dict(native.launch_counts)
        with pytest.raises(RuntimeError, match="refused"):
            vgg_stack(x, ws, out_dtype=dtype)
        assert native.launch_counts == before


def _tiny_asr(vocab_size, dtype):
    """(config, seeded model) of a small vgg_cnn Transformer."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.models.transformer import build_model, init_weights

    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 2, 4
    m.dim_model = m.dim_emb = m.dim_inner = 64
    m.dim_key = m.dim_value = m.r = 16
    m.dropout, m.dtype = 0.0, dtype
    m.src_max_len, m.tgt_max_len = 400, 200
    cfg.finalize()
    model = build_model(cfg, vocab_size)
    init_weights(model, torch.Generator().manual_seed(3))
    return cfg, model.eval()


def test_beam_bank_on_the_card_matches_the_cpu(dev):
    """The beam's bank at f32 (B 2, W 3, 10 steps): the card (FFT STFT
    not involved; the f32 VGG kernels) and the CPU (plain versions) keep
    the same hypotheses; raw scores within 1e-4."""
    from mtl_tpu_torch.decode.beam import NEG_INF, beam_decode_ids

    _, model = _tiny_asr(71, "float32")
    rng = np.random.RandomState(8)
    feats = torch.from_numpy(rng.randn(2, 96, 161).astype(np.float32))
    lengths = torch.tensor([96, 70])
    out = []
    for d in (dev, torch.device("cpu")):
        before = dict(native.launch_counts)
        res = beam_decode_ids(model.to(d), feats.to(d), lengths.to(d), 3,
                              10, 1, 0, 30, 0.1)
        out.append([r.cpu() for r in res])
        if d == dev:
            torch.cuda.synchronize()
            assert native.launch_counts["vgg_block1_f32"] == \
                before["vgg_block1_f32"] + 1
    (ct, cs, cw, cl), (pt, ps, pw, pl) = out
    assert torch.equal(ct, pt) and torch.equal(cl, pl) and torch.equal(cw, pw)
    real = ps > NEG_INF / 2
    assert torch.equal(cs > NEG_INF / 2, real)
    torch.testing.assert_close(cs[real], ps[real], rtol=1e-4, atol=1e-4)


def _fusion_lm(path):
    from mtl_tpu_torch.lm.fusion import save_lm_fusion
    from mtl_tpu_torch.lm.model import RNNLM, init_lm_weights

    words = ["<oov>", "<eos>", "the", "cat"] + [chr(0x4E00 + i)
                                               for i in range(40)]
    arch = {"rnn_type": "LSTM", "ntoken": len(words), "ninp": 200,
            "nhid": 200, "nlayers": 2, "dropout": 0.2, "tie_weights": False}
    lm = RNNLM("LSTM", len(words), 200, 200, 2, 0.2, False)
    init_lm_weights(lm, torch.Generator().manual_seed(4))
    save_lm_fusion(str(path), lm, {w: i for i, w in enumerate(words)}, arch)


def test_lm_scorer_on_the_card_matches_the_cpu_with_tf32_on(dev, tmp_path,
                                                            monkeypatch):
    """LM scores of a bank-sized batch on the card against the CPU, with
    TF32 allowed globally (torch's cuDNN default): the LM's f32 context
    holds them to 1e-5 and restores the flags."""
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.lm.fusion import LMScorer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _fusion_lm(tmp_path / "lm")
    vocab = Vocab.from_labels(list("abcdefghijklmnopqrstuvwxyz ")
                              + [chr(0x4E00 + i) for i in range(40)])
    rng = np.random.RandomState(2)
    id_lists = [[1] + rng.randint(4, len(vocab), size=n).tolist() + [2]
                for n in rng.randint(0, 300, size=64)]
    card = LMScorer.load(str(tmp_path / "lm"), dev).score_batch(id_lists,
                                                                 vocab)
    cpu = LMScorer.load(str(tmp_path / "lm"), torch.device("cpu"))
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    for ids, got in zip(id_lists, card):
        want = cpu.score_ids(ids, vocab)
        assert got[1:] == want[1:]
        assert abs(got[0] - want[0]) <= 1e-5, (got, want)


def test_beam_test_main_launches_each_kernel_once_a_batch(dev, tmp_path,
                                                          monkeypatch):
    """test_main --beam-search --lm-rescoring on cuda at bf16: the FFT
    STFT once a batch, both tensor-core VGG kernels once a batch (again
    for a batch that switches to greedy), the direct STFT never."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=1, utts_per_task=5, min_sec=1.0,
        max_sec=1.9, seed=2)
    vocab = Vocab.from_json(labels)
    cfg, model = _tiny_asr(len(vocab), "bfloat16")
    cfg.name, cfg.save_folder = "beam", str(tmp_path / "models")
    path = save_checkpoint(cfg, vocab, model.state_dict(), 0,
                           best_model=True)
    _fusion_lm(tmp_path / "lm")
    native.reset_launch_counts()
    res = test_main(["--test-manifest-list", manifests[0], "--labels-path",
                     labels, "--continue-from", path, "--k-test", "2",
                     "--beam-search", "--beam-width", "4", "--beam-nbest",
                     "3", "--lm-rescoring", "--lm-path",
                     str(tmp_path / "lm"), "--name", "beam", "--device",
                     dev.type])
    torch.cuda.synchronize()
    c = native.launch_counts
    assert res["utterances"] == 5
    batches, switched = 3, res["switched_to_greedy"]
    assert c["stft_logmag"] == batches and c["stft_logmag_direct"] == 0, c
    assert c["vgg_block1"] == c["vgg_block2"] == batches + switched, c
    assert c["vgg_block1_f32"] == c["vgg_block2_f32"] == 0, c
