#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port only (``mtl_tpu_torch``; nothing of JAX or ``mtl_tpu``):

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``mtl_tpu_torch/csrc`` (one nvcc each, all
   at once) and prints the build seconds;
3. at the flagship serving shapes (batch 8, bucket 800 frames, 16 kHz /
   20 ms / 10 ms, vgg_cnn) holds each kernel route against its plain
   PyTorch version on the card, with TF32 off, and times kernel, plain
   version and a library yardstick with CUDA events: both routes of the
   STFT (the FFT, served, and the direct DFT, timed in turns with it; the
   yardstick is the cuFFT chain torch.stft -> abs -> log1p), and both
   routes of both VGG blocks (bf16 tensor cores against the bf16-operand
   plain version, f32 CUDA cores against the f32 one);
4. writes a synthetic corpus of 4-8 s utterances (bucket 800 frames);
5. saves a seeded-init port checkpoint at the flagship width (vgg_cnn,
   2 enc / 4 dec, d_model 512, 8 heads, d_k = d_v = 64, d_inner 512,
   d_emb 512, r 100, bf16);
6. serves it with the port's ``test_main`` (greedy decode + CER/WER) on
   ``cuda`` and prints utterances/s and the TOTAL line; the launch counters
   are zeroed just before and read just after: the FFT STFT (once a batch,
   the direct one never) and both bf16 tensor-core VGG kernels must have
   launched;
7. checks the served path against the plain versions on a small input: the
   same weights at f32 on the card (kernels) and on the CPU (plain
   versions) must give the same features, encoder output and decode-step
   logits; the counters are zeroed before the card's run and read after
   it, and both f32 VGG kernels must have launched;
8. trains the flagship width through the port's
   ``meta_transfer_train_main`` on ``cuda`` (bf16, dropout 0.1) on a
   3-task corpus of 4-7.9 s utterances (one 800-frame bucket; the last
   task is the code-switched query and valid set), 3 tasks of 8 support
   and 8 query utterances, 6 meta steps with an evaluation and a
   checkpoint every 3; every TRAIN LOSS must be finite, the checkpoints
   must exist, and a ``--continue-from`` of the last must resume at
   iteration 7. The counters are zeroed before the run and read after it:
   the FFT STFT, both bf16 VGG kernels (at least 2K forward launches a
   step each) and the VGG stack's backward (at least 2K a step) must have
   run, the direct STFT never. Then one meta step is timed on device-side
   batches (median over the steps after the first), with the peak memory,
   and one step is profiled: its busy share and device time by kernel;
9. checks one meta step at f32 on the card (kernels, f32 routes) against
   the same step on the CPU (plain versions) from the same weights and
   batch (2 tasks of 2 utterances, 400 frames): outer loss, outer
   gradients and the params after the Adam update; the f32 VGG kernels and
   the stack's backward must have launched;
10. prints the kernels as one JSON line and, last, the result line.

Any failure raises, so the script exits non-zero and prints no result. It
also exits non-zero when torch finds no CUDA device, or when run from a
directory that does not hold the port. Everything it writes goes under
``build/chip_smoke/`` (listed in .gitignore).
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
SEED = 0

# flagship serving shapes
B, T, N_FFT, HOP, NFREQ = 8, 800, 320, 160, 161
# H100 SXM dense peaks (NVIDIA data sheet), at a 700 W power limit
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
UTTERANCES = 20  # 3 served batches of 8, the last padded with duplicates


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, kernel, iters=20):
    """Device time of the named kernel per call of ``fn``, by
    torch.profiler: the kernel alone, without the wrapper's other work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    # the profiler may drop an event now and then: average over those seen
    check(iters // 2 <= len(times) <= iters,
          f"profiler saw {len(times)} {kernel} launches of {iters}")
    return sum(times) / 1e3 / len(times)


def _bound_ms(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernels(torch, dev):
    """Phase 3: each kernel against its plain version at the flagship
    shapes; returns the kernels' records (launches filled in later)."""
    import torch.nn.functional as F

    from mtl_tpu_torch.ops.stft import (device_dft_matrices, device_fft_tables,
                                        stft_logmag, stft_logmag_direct,
                                        stft_logmag_plain, stft_route)
    from mtl_tpu_torch.ops.vgg import (hwio_to_oihw, pack_block1_tc,
                                       pack_block2_tc, vgg_block1, vgg_block2,
                                       vgg_block_plain)

    rng = np.random.RandomState(SEED)
    records = []

    def report(rec, err, rel, tol):
        lib = rec["library_ms"]
        print(f"kernel {rec['name']}: max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} tol {tol}; ms {rec['ms']:.4f} plain_ms "
              f"{rec['plain_ms']:.4f} library_ms "
              f"{'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']}; "
              f"{rec['_bound_note']})", flush=True)
        records.append(rec)

    # -- kernel 1: STFT log-magnitude, f32, both routes --------------------
    # n_fft 320 takes the FFT route on the served path; the direct route
    # (the GEMM form, kept for n_fft with a prime factor above 5) runs
    # through its launcher at the same shapes, as the old design's yardstick
    s = (T - 1) * HOP + N_FFT
    audio = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (B, s)).astype(np.float32)).to(dev)
    cos_b, nsin_b = device_dft_matrices(N_FFT, "hamming", dev)
    win, tw = device_fft_tables(N_FFT, "hamming", dev)
    check(stft_route(N_FFT) == "fft", "n_fft 320 must take the FFT route")
    ref = stft_logmag_plain(audio, cos_b, nsin_b, T, HOP)
    routes = {  # name -> (call, kernel name for the profiler)
        "fft": (lambda: stft_logmag(audio, N_FFT, HOP, T, "hamming"),
                "stft_fft_kernel"),
        "direct": (lambda: stft_logmag_direct(audio, cos_b, nsin_b, T,
                                              HOP), "stft_logmag_kernel"),
    }
    errs = {}
    for route, (fn, _) in routes.items():
        out = fn()
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (B, T, NFREQ), f"stft {route} shape")
        check(bool(torch.isfinite(out).all()), f"stft {route} not finite")
        d = (out - ref).abs()
        errs[route] = (float(d.max()),
                       float((d / ref.abs().clamp_min(1e-6)).max()))
        # f32 on both sides; only the order of the sums differs
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)

    def cufft_chain():
        """The same function and layout in one library chain (cuFFT)."""
        return torch.stft(audio, N_FFT, HOP, window=win, center=False,
                          return_complex=True).abs().log1p().transpose(
                              1, 2).contiguous()

    lib_err = float((cufft_chain() - ref).abs().max())
    torch.testing.assert_close(cufft_chain(), ref, rtol=1e-4, atol=1e-4)
    # turns: direct, FFT, FFT, direct -- wrapper calls by CUDA events, the
    # kernel alone by torch.profiler
    turns = []
    for route in ("direct", "fft", "fft", "direct"):
        fn, kernel = routes[route]
        turns.append((route, _time_ms(fn), _device_ms(fn, kernel)))
    by = {r: [(ms, alone) for rt, ms, alone in turns if rt == r]
          for r in routes}
    plain_ms = _time_ms(
        lambda: stft_logmag_plain(audio, cos_b, nsin_b, T, HOP))
    library_ms = _time_ms(cufft_chain)
    m = N_FFT // 2
    # the packed M-point complex FFT (5 M log2 M) and the split and
    # magnitude (~10 a bin), per frame; the GEMM form for the note
    fft_flops = B * T * (5 * m * math.log2(m) + 10 * NFREQ)
    gemm_flops = 4 * B * T * N_FFT * NFREQ
    nbytes = _nbytes(audio, win, tw, ref)
    bound, bound_by = _bound_ms(nbytes, fft_flops, PEAK_F32)
    fft_ms = sum(ms for ms, _ in by["fft"]) / 2
    fft_alone = [alone for _, alone in by["fft"]]
    print("kernel stft_logmag turns (route, ms, kernel alone ms): "
          + "; ".join(f"{r} {ms:.4f} {a:.4f}" for r, ms, a in turns)
          + f"; fft alone {bound / min(fft_alone):.3f} of its bound; direct "
          f"route (csrc/stft.cu) max_abs_err {errs['direct'][0]:.3e} "
          f"direct_ms {sum(ms for ms, _ in by['direct']) / 2:.4f}; cuFFT "
          f"chain max_abs_err {lib_err:.3e}", flush=True)
    report({
        "name": "stft_logmag", "route": "cuda",
        "source": "mtl_tpu_torch/csrc/stft_fft.cu",
        "replaces": "mtl_tpu/ops/stft_pallas.py:59",
        "max_abs_err": errs["fft"][0], "ms": fft_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by,
        "_bound_note": f"{nbytes} B at 3.35 TB/s; the FFT's {fft_flops:.3e} "
                       f"flop at f32 67 TFLOP/s; the GEMM form's "
                       f"{gemm_flops:.3e} flop would take "
                       f"{gemm_flops / PEAK_F32 * 1e3:.4f} ms",
        "_path": "serve",
    }, *errs["fft"], "rtol=atol=1e-4 (f32, summation order)")

    # -- kernels 2 and 3: fused VGG blocks, both routes --------------------
    def weights(c_in, c):
        def xavier(*shape):
            fan_in, fan_out = 9 * shape[2], 9 * shape[3]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        ws = [xavier(3, 3, c_in, c), rng.randn(c).astype(np.float32) * 0.1,
              xavier(3, 3, c, c), rng.randn(c).astype(np.float32) * 0.1]
        return [torch.from_numpy(w).to(dev) for w in ws]

    def library(x, w1, b1, w2, b2):
        """cuDNN conv chain at the model's bf16, channels_last."""
        y = F.relu(F.conv2d(x, w1, b1, padding=1))
        y = F.relu(F.conv2d(y, w2, b2, padding=1))
        return F.max_pool2d(y, 2)

    bf16, f32 = torch.bfloat16, torch.float32
    x1 = torch.from_numpy(rng.randn(B, T, NFREQ).astype(np.float32)).to(dev)
    w_1, w_2 = weights(1, 64), weights(64, 128)
    # block 2 runs on block 1's output of the same route, as on the paths
    x2 = {d: vgg_block1(x1, *w_1, out_dtype=d) for d in (bf16, f32)}
    for name, fn, x, ws, c_in, c, pack, src_line, dtype in (
            ("vgg_block1", vgg_block1, x1, w_1, 1, 64, pack_block1_tc, 260,
             bf16),
            ("vgg_block1_f32", vgg_block1, x1, w_1, 1, 64, None, 260, f32),
            ("vgg_block2", vgg_block2, x2[bf16], w_2, 64, 128, pack_block2_tc,
             305, bf16),
            ("vgg_block2_f32", vgg_block2, x2[f32], w_2, 64, 128, None, 305,
             f32)):
        out = fn(x, *ws, out_dtype=dtype)
        ref = vgg_block_plain(x, *ws, out_dtype=dtype)
        torch.cuda.synchronize()
        t_img, f_img = x.shape[1], x.shape[2]
        check(out.shape == ref.shape == (B, t_img // 2, f_img // 2, c)
              and out.dtype == dtype, f"{name} shape")
        check(bool(torch.isfinite(out.float()).all()), f"{name} not finite")
        d = (out.float() - ref.float()).abs()
        err = float(d.max())
        rel = float((d / ref.float().abs().clamp_min(1e-6)).max())
        flops = 2 * B * t_img * f_img * 9 * (c_in * c + c * c)
        if dtype == bf16:
            # bf16-operand plain version; both sum in f32 in other orders,
            # so a conv-1 value near a bf16 rounding boundary may round to
            # its neighbour and the output may round to its neighbour
            tol = "|d| <= 2^-7 |plain| + 2^-10 (one bf16 ulp)"
            bad = int((d > 2.0 ** -7 * ref.float().abs() + 2.0 ** -10).sum())
            off = float((out.float() - vgg_block_plain(
                x, *ws, out_dtype=f32)).abs().max())
            print(f"kernel {name}: {bad} of {d.numel()} outside tol; "
                  f"max_abs_err vs the f32 plain version {off:.3e}; "
                  f"weight packing ms {_time_ms(lambda: pack(ws[0], ws[2])):.4f}",
                  flush=True)
            check(bad == 0, f"{name} differs from its plain version by {err}")
            bound, by = _bound_ms(_nbytes(x, *ws, out), flops, PEAK_BF16)
            note = f"{flops:.3e} flop at bf16 tensor cores 989 TFLOP/s"
            xl = (x.reshape(B, t_img, f_img, c_in).permute(0, 3, 1, 2)
                  .to(bf16).contiguous(memory_format=torch.channels_last))
            wl = [hwio_to_oihw(w).to(bf16).contiguous(
                memory_format=torch.channels_last) if w.dim() == 4
                  else w.to(bf16) for w in ws]
            library_ms = _time_ms(lambda: library(xl, *wl))
            source, path = "mtl_tpu_torch/csrc/vgg_tc.cu", "serve"
            kernel = f"{name}_tc_kernel"
        else:
            # f32 on both sides (TF32 off); only summation order differs
            tol = "rtol=atol=1e-4 (f32, summation order)"
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            bound, by = _bound_ms(_nbytes(x, *ws, out), flops, PEAK_F32)
            note = f"{flops:.3e} flop at f32 67 TFLOP/s"
            xl = (x.reshape(B, t_img, f_img, c_in).permute(0, 3, 1, 2)
                  .contiguous(memory_format=torch.channels_last))
            wl = [hwio_to_oihw(w).contiguous(
                memory_format=torch.channels_last) if w.dim() == 4 else w
                  for w in ws]
            # the f32 cuDNN chain in channels_last (TF32 off)
            library_ms = _time_ms(lambda: library(xl, *wl))
            source, path = "mtl_tpu_torch/csrc/vgg.cu", "parity"
            kernel = "vgg_block_kernel"
        k_ms = _device_ms(lambda: fn(x, *ws, out_dtype=dtype), kernel)
        print(f"kernel {name}: {kernel} alone {k_ms:.4f} ms of device time "
              f"(torch.profiler), {bound / k_ms:.3f} of its bound", flush=True)
        report({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"mtl_tpu/ops/vgg_pallas.py:{src_line}",
            "max_abs_err": err,
            "ms": _time_ms(lambda: fn(x, *ws, out_dtype=dtype)),
            "plain_ms": _time_ms(
                lambda: vgg_block_plain(x, *ws, out_dtype=dtype)),
            "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by,
            "_bound_note": note, "_path": path,
        }, err, rel, tol)
    return records


def serve(torch, dev, corpus_dir, models_dir):
    """Phases 4-6: corpus, seeded flagship checkpoint, test_main on cuda.
    Returns (test_main's result, its stdout, wall seconds, seconds of audio
    served, launch counts, checkpoint path)."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.data.audio import load_audio
    from mtl_tpu_torch.data.dataset import read_manifest
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    manifests, labels_path = make_synthetic_corpus(
        corpus_dir, num_tasks=1, utts_per_task=UTTERANCES, min_sec=4.0,
        max_sec=7.9, seed=SEED)
    with open(labels_path, encoding="utf-8") as f:
        vocab = Vocab.from_labels(json.load(f))
    audio_s = sum(len(load_audio(wav)) for wav, _ in read_manifest(
        manifests[0])) / 16000.0

    cfg = Config()  # flagship width: the defaults, spelled out
    m = cfg.model
    m.feat_extractor, m.num_enc_layers, m.num_dec_layers = "vgg_cnn", 2, 4
    m.num_heads, m.dim_model, m.dim_key, m.dim_value = 8, 512, 64, 64
    m.dim_inner, m.dim_emb, m.r, m.dtype = 512, 512, 100, "bfloat16"
    cfg.name, cfg.save_folder = "chip_smoke", models_dir
    cfg.finalize()
    model = build_model(cfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(SEED))
    ckpt = save_checkpoint(cfg, vocab, model.state_dict(), step=0,
                           best_model=True)
    print(f"checkpoint: {sum(p.numel() for p in model.parameters())} params "
          f"at {ckpt}", flush=True)

    argv = ["--test-manifest-list", manifests[0], "--labels-path",
            labels_path, "--continue-from", ckpt, "--name", "chip_smoke",
            "--device", dev.type, "--k-valid", "8", "--k-test", "8"]
    buf = io.StringIO()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = test_main(argv)
    sync()
    wall = time.perf_counter() - t0
    counts = dict(native.launch_counts)
    return result, buf.getvalue(), wall, audio_s, counts, ckpt


def check_against_plain(torch, dev, ckpt, corpus_dir):
    """Phase 7: the served path with kernels (card) vs plain versions (CPU),
    same weights at f32, on two utterances cut to 400 frames. Returns the
    launch counts of the card's run (the f32 routes of the VGG blocks)."""
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.train.steps import prepare_features
    from mtl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, vocab, sd, _, _ = load_checkpoint(ckpt)
    cfg.model.dtype = "float32"
    ds = SpectrogramDataset(vocab, cfg, [os.path.join(
        corpus_dir, "manifest_task0.csv")])
    batch = next(ds.iter_batches(2, shuffle=False, force_frames=400))
    outs = []  # [card, cpu]
    torch.cuda.synchronize()
    native.reset_launch_counts()
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            model = build_model(cfg, len(vocab))
            model.load_state_dict({k: v.float() for k, v in sd.items()})
            model = model.to(d).eval()
            feats, lengths = prepare_features(
                {k: torch.from_numpy(batch[k]).to(d)
                 for k in ("audio", "audio_lengths")}, cfg)
            enc, kvs = model.prepare_decode(feats, lengths)
            caches = model.init_cache(2, 4, d)
            y = torch.full((2,), vocab.SOS_ID, dtype=torch.long, device=d)
            logits = []
            for t in range(3):
                lg, caches = model.decode_step(y, t, kvs, caches)
                logits.append(lg)
                y = lg.argmax(-1)
            outs.append([feats, enc] + logits)
            if d == dev:
                torch.cuda.synchronize()
                counts = dict(native.launch_counts)
    for name, a, b in zip(("features", "encoder", "logits0", "logits1",
                           "logits2"), *outs):
        a = a.float().cpu()
        check(bool(torch.isfinite(a).all()), f"{name} not finite")
        err = float((a - b).abs().max())
        print(f"card vs cpu {name} {tuple(a.shape)}: max_abs_err {err:.3e}",
              flush=True)
        # f32 on both sides, TF32 off: summation order only
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    return counts


TRAIN_FLAGS = [  # the flagship width (the CLI's defaults differ)
    "--feat_extractor", "vgg_cnn", "--num-enc-layers", "2",
    "--num-dec-layers", "4", "--num-heads", "8", "--dim-model", "512",
    "--dim-key", "64", "--dim-value", "64", "--dim-inner", "512",
    "--dim-emb", "512", "--r", "100", "--dtype", "bfloat16"]
K_TASKS, K_SHOT, TRAIN_STEPS = 3, 8, 6


class _Recorder:
    """An outer optimizer that keeps the outer gradients and moves nothing
    (the meta step's gradients, read out)."""

    def update(self, grads, state, params):
        self.grads = {k: g.detach().float().cpu() for k, g in grads.items()}
        return state


def _busy_ms(events, torch):
    """Union of the device kernels' intervals, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


KERNEL_GROUPS = (  # (group, substrings of a kernel's name), first match
    ("port kernels: vgg_tc forward", ("vgg_block",)),
    ("port kernels: stft_fft", ("stft",)),
    ("cuDNN convs + layouts (VGG backward recompute)",
     ("conv", "cudnn", "fprop", "dgrad", "wgrad", "nchw", "nhwc",
      "implicit")),
    ("GEMMs (linears, attention products)", ("gemm", "cutlass", "matmul",
                                             "gemv")),
    ("multi-tensor foreach (inner SGD, clip, Adam)",
     ("multi_tensor", "foreach")),
    ("max-pool", ("pool",)),
    ("softmax / log-softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("elementwise + copies", ("elementwise", "vectorized", "copy", "fill",
                              "unrolled", "where", "cat")),
)


def train(torch, dev, work):
    """Phase 8. Returns (launch counts of the main run, corpus dir)."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.config import build_parser, config_from_args
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.train.optim import make_meta_optimizers
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    corpus = os.path.join(work, "train_corpus")
    manifests, labels = make_synthetic_corpus(
        corpus, num_tasks=K_TASKS, utts_per_task=16, min_sec=4.0,
        max_sec=7.9, seed=SEED + 1)
    models = os.path.join(work, "train_models")
    argv = (["--train-manifest-list", *manifests, "--valid-manifest-list",
             manifests[-1], "--labels-path", labels, "--device", dev.type,
             "--k-train", str(K_SHOT), "--k-valid", str(K_SHOT),
             "--evaluate-every", "3", "--save-every", "3", "--dropout", "0.1",
             "--save-folder", models, "--src-buckets", "800"] + TRAIN_FLAGS)
    buf = io.StringIO()
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = meta_transfer_train_main(
            argv + ["--epochs", str(TRAIN_STEPS), "--name", "chip_train"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(native.launch_counts)
    out = buf.getvalue()
    with open(os.path.join(work, "train.txt"), "w", encoding="utf-8") as f:
        f.write(out)
    lines = [ln for ln in out.splitlines() if "TRAIN LOSS" in ln]
    for ln in lines + [ln for ln in out.splitlines() if "VALID" in ln]:
        print(ln, flush=True)
    losses = [float(re.search(r"TRAIN LOSS:(\S+)", ln).group(1))
              for ln in lines]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train losses {losses}")
    check(state.step == TRAIN_STEPS, f"trained {state.step} steps")
    for tag in ("step_3", "step_6", "best_model"):
        for name in ("model.pt", "train_state.pt", "meta.json"):
            check(os.path.exists(os.path.join(models, "chip_train", tag,
                                              name)), f"{tag}/{name}")
    totals = [float(re.search(r"TOTAL TIME:(\S+)", ln).group(1))
              for ln in lines]
    per_it = sorted(b - a for a, b in zip(totals, totals[1:]))
    print(f"train run: {TRAIN_STEPS} meta steps (K {K_TASKS}, {K_SHOT} + "
          f"{K_SHOT} utterances, bf16) in {wall:.3f} s with 2 evaluations "
          f"and 3 checkpoints; TOTAL TIME per iteration after the first "
          f"(host clock, batch to device + step + train CER): median "
          f"{per_it[len(per_it) // 2] * 1e3:.3f} ms", flush=True)
    print(f"launches in the train run: {counts}", flush=True)
    need = 2 * K_TASKS * TRAIN_STEPS
    check(all(counts[k] >= need for k in ("vgg_block1", "vgg_block2",
                                          "vgg_stack_bwd"))
          and counts["stft_logmag"] >= (K_TASKS + 1) * TRAIN_STEPS
          and counts["stft_logmag_direct"] == 0,
          f"the train run must launch each VGG kernel and the backward "
          f">= {need} times, the FFT STFT >= {(K_TASKS + 1) * TRAIN_STEPS},"
          f" the direct STFT never: {counts}")

    # resume from the last checkpoint: iterations 7 and 8
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = meta_transfer_train_main(argv + [
            "--epochs", str(TRAIN_STEPS + 2), "--name", "chip_train_resume",
            "--continue-from", os.path.join(models, "chip_train", "step_6")])
    its = [int(x) for x in re.findall(r"\(Iteration (\d+)\) TRAIN LOSS",
                                      buf.getvalue())]
    check(its == [TRAIN_STEPS + 1, TRAIN_STEPS + 2]
          and state.opt_state.count == TRAIN_STEPS + 2,
          f"resume ran iterations {its}, Adam count {state.opt_state.count}")
    print(f"resume from step_6: iterations {its}, Adam count "
          f"{state.opt_state.count}", flush=True)

    # one meta step, timed and profiled on device-side batches
    cfg = config_from_args(build_parser("").parse_args(argv + [
        "--name", "chip_train_timing"]))
    with open(labels, encoding="utf-8") as f:
        vocab = Vocab.from_labels(json.load(f))
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=SEED)
    batches = [[batch_to_device(b, dev) for b in ds.sample_meta_batch(
        K_SHOT, K_SHOT)] for _ in range(6)]
    model = build_model(cfg, len(vocab), dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    _, opt = make_meta_optimizers(cfg)
    state = init_train_state(model, opt)
    step = make_meta_step(model, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for sup, qry in batches[:5]:
        t0 = time.perf_counter()
        state, m = step(state, sup, qry, gen)
        float(m["outer_loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    steady = sorted(ms[1:])
    print(f"meta step (flagship, bf16, K {K_TASKS}, {K_SHOT}+{K_SHOT}, "
          f"{batches[0][0]['audio'].shape[-1]} samples a row): "
          + ", ".join(f"{v:.3f}" for v in ms) + f" ms; median after the "
          f"first {(steady[1] + steady[2]) / 2:.3f} ms; peak memory "
          f"{peak:.1f} MiB", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, *batches[5], gen)
        float(m["outer_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = _busy_ms(events, torch)
    by_name = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    groups = {}
    for name, t in by_name.items():
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS
                  if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + t
    print(f"profiled meta step: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, busy share {busy / wall_ms:.4f}; device ms by "
          f"group: " + "; ".join(f"{g} {t:.3f}" for g, t in sorted(
              groups.items(), key=lambda x: -x[1])), flush=True)
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        print(f"  top device op {t:9.3f} ms  {name[:110]}", flush=True)
    host_ops = [e for e in events if e.cpu_parent is None
                and e.device_type == torch.autograd.DeviceType.CPU]
    print(f"host: {len(host_ops)} top-level ops in the step "
          f"({wall_ms * 1e3 / max(len(host_ops), 1):.1f} us of wall each, "
          f"profiler on); by self CPU time:", flush=True)
    for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total
                    )[:10]:
        print(f"  top host op {a.self_cpu_time_total / 1e3:9.3f} ms "
              f"{a.count:6d} calls  {a.key[:80]}", flush=True)
    return counts, corpus


def train_parity(torch, dev, corpus):
    """Phase 9: one f32 meta step on the card (kernels) against the CPU
    (plain versions). Returns the card run's launch counts."""
    from mtl_tpu_torch.config import build_parser, config_from_args
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    m0, m2 = (os.path.join(corpus, f"manifest_task{i}.csv") for i in (0, 2))
    cfg = config_from_args(build_parser("").parse_args(
        ["--labels-path", os.path.join(corpus, "labels.json"),
         "--dropout", "0"] + TRAIN_FLAGS[:-1] + ["float32"]))
    with open(cfg.data.labels_path, encoding="utf-8") as f:
        vocab = Vocab.from_labels(json.load(f))
    ds = SpectrogramDataset(vocab, cfg, [m0, m2], is_train=True, seed=SEED)
    sup = [ds._collate(ds.sample_pairs(2, i), 400, 64) for i in (0, 1)]
    support = {k: np.stack([b[k] for b in sup]) for k in sup[0]}
    query = ds._collate(ds.sample_pairs(2, 1), 400, 64)
    ref = build_model(cfg, len(vocab))
    init_weights(ref, torch.Generator().manual_seed(SEED + 2))
    rng = np.random.RandomState(SEED)
    with torch.no_grad():  # trained conv biases are not zero
        for conv in ref.conv.convs:
            conv.bias.copy_(torch.from_numpy(
                rng.randn(conv.bias.numel()).astype(np.float32) * 0.1))
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    lr = cfg.train.meta_lr
    res = []  # [card, cpu]
    for d in (dev, torch.device("cpu")):
        out = {}
        for name, opt in (("grads", _Recorder()), ("adam", Adam(lr))):
            model = build_model(cfg, len(vocab), d)
            model.load_state_dict(weights)
            state = init_train_state(model, Adam(lr))
            if d == dev and name == "adam":
                torch.cuda.synchronize()
                native.reset_launch_counts()
            state, m = make_meta_step(model, cfg, opt)(
                state, batch_to_device(support, d), batch_to_device(query, d))
            out[name] = opt.grads if name == "grads" else {
                k: v.detach().cpu() for k, v in state.params.items()}
            out[f"{name}_loss"] = float(m["outer_loss"])
            if d == dev and name == "adam":
                torch.cuda.synchronize()
                counts = dict(native.launch_counts)
        res.append(out)
    card, cpu = res
    for key in ("grads_loss", "adam_loss"):
        print(f"train parity {key}: card {card[key]:.7f} cpu {cpu[key]:.7f}",
              flush=True)
        check(math.isclose(card[key], cpu[key], rel_tol=1e-3),
              f"outer loss card {card[key]} cpu {cpu[key]}")
    scale = max(float(g.abs().max()) for g in cpu["grads"].values())
    gerr = max(float((card["grads"][k] - g).abs().max())
               for k, g in cpu["grads"].items())
    # f32 on both sides, TF32 off: summation order only
    for k, g in cpu["grads"].items():
        torch.testing.assert_close(card["grads"][k], g, rtol=1e-3,
                                   atol=1e-3 * scale)
    # Adam's first step moves each weight by about lr * sign(g); entries
    # whose gradient is below 1e-3 of the largest may take either sign
    # on either side, the rest must agree to 0.1 lr
    perr, checked = 0.0, 0
    for k, p in cpu["adam"].items():
        d = (card["adam"][k] - p).abs()
        check(float(d.max()) <= 2 * lr + 1e-7, f"{k} moved {float(d.max())}")
        sure = cpu["grads"][k].abs() > 1e-3 * scale
        if sure.any():
            perr = max(perr, float(d[sure].max()))
            checked += int(sure.sum())
    check(perr <= 0.1 * lr, f"post-step params differ by {perr}")
    print(f"train parity (f32, 2 tasks x 2 utterances, 400 frames): outer "
          f"grads max_abs_err {gerr:.3e} of max {scale:.3e}; post-step "
          f"params max_abs_err {perr:.3e} (meta_lr {lr}) over {checked} "
          f"entries with |g| > 1e-3 max", flush=True)
    print(f"launches in the f32 train parity run: {counts}", flush=True)
    check(all(counts[k] >= 4 for k in ("vgg_block1_f32", "vgg_block2_f32",
                                       "vgg_stack_bwd")),
          f"the f32 step must run the f32 VGG kernels and the backward: "
          f"{counts}")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import mtl_tpu_torch
    from mtl_tpu_torch.ops import native

    if not os.path.abspath(mtl_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"mtl_tpu_torch found at {mtl_tpu_torch.__file__}, "
                           f"not in {HERE}")
    os.chdir(HERE)  # test_main logs to ./log
    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    reports = native.build()
    print(f"build_s {time.perf_counter() - t0:.2f} ("
          + ", ".join(f"{native.SOURCES[n]} {sec:.2f}"
                      for n, (sec, _) in reports.items())
          + "; one nvcc each, all at once)", flush=True)
    with open(os.path.join(WORK, "ptxas.txt"), "w") as f:
        for name, (_, log) in reports.items():
            f.write(f"== {name}\n{log}\n")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    # 3. kernels against their plain versions
    records = check_kernels(torch, dev)

    # 4-6. serve the flagship checkpoint
    corpus_dir = os.path.join(WORK, "corpus")
    result, out, wall, audio_s, counts, ckpt = serve(
        torch, dev, corpus_dir, os.path.join(WORK, "models"))
    with open(os.path.join(WORK, "test_main.txt"), "w", encoding="utf-8") as f:
        f.write(out)
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL CER")]
    preds = [ln for ln in out.splitlines() if ln.startswith("PRED:")]
    check(len(total) == 1 and len(preds) == UTTERANCES
          and result["utterances"] == UTTERANCES,
          f"served {len(preds)} PRED lines, {len(total)} TOTAL lines")
    check(all(math.isfinite(result[k])
              for k in ("cer", "wer", "en_cer", "zh_cer")), str(result))
    print(total[0], flush=True)
    print(f"served {UTTERANCES} utterances ({audio_s:.3f} s of audio) in "
          f"{wall:.3f} s: {UTTERANCES / wall:.3f} utterances/s, real-time "
          f"factor {wall / audio_s:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print(f"launches in the served run: {counts}", flush=True)
    batches = math.ceil(UTTERANCES / 8)
    check(counts["stft_logmag"] == batches
          and counts["stft_logmag_direct"] == 0,
          f"the served run must launch the FFT STFT once a batch "
          f"({batches}) and the direct one never: {counts}")

    # 7. the served path against the plain versions, at f32
    parity = check_against_plain(torch, dev, ckpt, corpus_dir)
    print(f"launches in the f32 parity run: {parity}", flush=True)

    # 8. train the flagship width through the CLI; 9. f32 train parity
    t0 = time.perf_counter()
    _, train_corpus = train(torch, dev, WORK)
    train_parity(torch, dev, train_corpus)
    print(f"train phases {time.perf_counter() - t0:.1f} s", flush=True)

    # each kernel route must have run on its path: the bf16 tensor-core VGG
    # kernels and the STFT on the served path, the f32 VGG kernels on the
    # f32 parity path
    by_path = {"serve": counts, "parity": parity}
    for r in records:
        r["launches"] = by_path[r.pop("_path")].get(r["name"], 0)
        del r["_bound_note"]
    missing = [r["name"] for r in records if r["launches"] < 1]
    if missing:
        raise RuntimeError(f"kernels not launched on their path: {missing}")

    # 10. results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
