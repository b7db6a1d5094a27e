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
   STFT (the FFT, served, and the direct DFT on 3xTF32 tensor cores, timed
   in turns with it at n_fft 320 and with the cuFFT chain torch.stft ->
   abs -> log1p at its own 22.05 kHz shape, n_fft 441, hop 220, 221
   bins), and both routes of both VGG blocks (bf16 tensor cores against
   the bf16-operand plain version; f32, both on 3xTF32 tensor cores,
   against the f32 one; block 1's f32 time alone and its share of the
   bound at 161, 80 and 221 bins, here and in 3b, 3c). An f32 GEMM-form row
   (the direct STFT, both f32 VGG blocks) is bound by the larger of its
   bytes at 3.35 TB/s and its operations at the faster of f32 FMAs (67
   TFLOP/s) and 3xTF32 (three passes at 495);
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
6b. (after 7) serves 8 synthetic utterances of 4-7.9 s at 22.05 kHz
   (n_fft 441, hop 220, 221 bins) with a seeded checkpoint at the flagship
   width (vgg_cnn on 221 bins) through ``test_main`` on ``cuda``, the
   counters zeroed before and read after: the direct STFT once a batch,
   the FFT STFT never, both bf16 VGG kernels once a batch (the direct
   route's ``launches``); then one batch's front-end on the card against
   the CPU (raw and normalized, rtol = atol = 1e-4);
8. serves the same checkpoint and corpus by beam search with LM shallow
   fusion, README's command (``--beam-search --beam-width 8 --beam-nbest
   5 --lm-rescoring --lm-path``; horizon 200 steps at 800 frames): first
   an LM at ``lm_parser``'s defaults (LSTM 200/200, 2 layers, untied,
   seeded) over a synthetic word corpus is saved, tested on ``cuda`` by
   the LM's ``test_main`` (its perplexity/transition JSON printed) and
   converted by ``convert_main``; then ``test_main`` serves on ``cuda``
   with the counters zeroed before and read after: the FFT STFT once a
   batch, both bf16 VGG kernels once a batch (and again for a batch that
   switches to greedy, which fewer than all batches may do), the direct
   STFT never. Prints utterances/s, the real-time factor, the batches
   switched to greedy, the TOTAL line and peak memory; then one batch
   taken apart (ms per beam step, the LM scoring's ms and sequences) and
   profiled (busy share, top device ops); then the beam at f32 on the
   card against the CPU (B 2, W 3, 10 steps: equal bank tokens, lengths
   and word counts, raw scores within 1e-4; the LM's scores of the
   bank's hypotheses within 1e-5, on the card with TF32 allowed);
9. trains the flagship width through the port's
   ``meta_transfer_train_main`` on ``cuda`` (bf16, dropout 0.1) on a
   3-task corpus of 4-7.9 s utterances (one 800-frame bucket; the last
   task is the code-switched query and valid set), 3 tasks of 8 support
   and 8 query utterances, 6 meta steps with an evaluation and a
   checkpoint every 3; every TRAIN LOSS must be finite, the checkpoints
   must exist, and a ``--continue-from`` of the last must resume at
   iteration 7. The counters are zeroed before the run and read after it:
   the FFT STFT, both bf16 VGG kernels (at least 2K forward launches a
   step each) and the VGG stack's backward (at least 2K a step) must have
   run, the direct STFT never. The trainer replays the step as CUDA
   graphs (``train/graphs.py``), whose kernels count at the eager steps and
   the captures alone: the counts are held against the steps that ran the
   step's host code (the steps less ``meta_graph_replays``, plus
   ``meta_graph_captures``), and at least one replay must have run. Then
   one meta step is timed on device-side batches (median over the steps
   after the first), with the peak memory, and one step is profiled: its
   busy share and device time by kernel;
9b. the graph-replayed meta step (``GraphedMetaStep``) against the eager
   step from the same weights over the same host batches, at the flagship
   width (bf16, dropout 0.1, K 3 x 8 + 8 of the phase-9 corpus) over the
   keys A, A, B, B, A (800 frames x 128 labels, 1600 x 256), cuDNN on its
   deterministic algorithms in both runs: every step's metrics, the
   weights and Adam's moments bit-equal or within one bf16 ulp of the
   largest element; the kernel launches of each replay (its capture's)
   added to the counted ones give the eager run's. Then the memory at
   configs[4]'s width: the eager step and the graphed step over 800 x 128
   three times, 2500 x 256 (the default grid's largest bucket) three
   times and 800 x 128 again, each run from an empty cache, printing each
   step's seconds and the card's reserved bytes (the allocator's peak and
   the graphs' pool); the graphed run may reserve at most 1.1 times the
   eager run's peak;
10. checks one meta step at f32 on the card (kernels, f32 routes) against
   the same step on the CPU (plain versions) from the same weights and
   batch (2 tasks of 2 utterances, 400 frames): outer loss, outer
   gradients and the params after the Adam update; the f32 VGG kernels and
   the stack's backward must have launched;
11. trains the same width through ``joint_train_main`` on ``cuda`` (Adam,
   the phase-9 corpus, 3 tasks of 8 utterances, 6 iterations, an
   evaluation and a checkpoint every 3) with the counters zeroed before and
   read after: the FFT STFT, both bf16 VGG kernels and the stack's backward
   at least K times a step, the direct STFT and the f32 VGG kernels never;
   then ``finetune_main --opt_name sgd`` from phase 9's meta checkpoint
   (whose config names nesterov SGD, so its Adam state is left and the
   weights alone restored) for iterations 7-9; then one joint step timed
   and profiled as in phase 9;
12. checks one joint step at f32 on the card against the CPU as phase 10
   does: loss, gradients, params after Adam and after nesterov SGD;
13. runs the LM's four training mains on ``cuda`` at ``lm_parser``'s
   defaults (LSTM, emsize 200, nhid 200, 2 layers, batch 20, bptt 35,
   dropout 0.2, lr 20, clip 0.25) over three written word corpora of
   100,000 training tokens and ~20,000 words in all: ``main_main`` for 2
   epochs on the code-switched corpus, ``main_joint_main`` and
   ``main_meta_transfer_main`` for 40 iterations over the three,
   ``main_meta_transfer_main --second-order`` for 6, ``finetune_main`` of
   the meta checkpoint for an epoch and the LM's ``test_main`` on the
   result; every printed loss must be finite and every checkpoint exist;
14. times each LM step (a plain window, a joint iteration, a meta
   iteration of first and of second order) at those widths: the median of
   10 steps after 2, the peak memory and one profiled step's busy share;
15. checks one LM step of each kind at f32 (dropout 0) on the card with
   TF32 allowed globally against the CPU: loss within 1e-5 relative,
   params after the step within 1e-5 * lr;
16. trains MAML at the flagship width through ``meta_train_main`` on
   ``cuda`` (bf16, dropout 0.1) on the phase-9 corpus: 3 tasks of 8
   support and 8 own-query utterances, 6 iterations with an evaluation and
   a checkpoint every 3, then ``--num-meta-test 2``; every loss finite,
   the Meta-test line printed; the counters zeroed before and read after:
   the FFT STFT, both bf16 VGG kernels and the stack's backward at least
   2K times a step, the direct STFT never; then one MAML step timed
   (median after the first), its peak memory and a profiled busy share;
17. the discriminator heads: ``joint_train_main --adversarial
   --beta-decay`` for 6 iterations and ``meta_transfer_train_main
   --multitask`` for 3 (each with its launch counts), a ``--continue-from``
   of the joint run resuming at iteration 7 with the discriminator and
   both optimizer states restored, ``test_main`` serving the disc-trained
   checkpoint, one adversarial joint step timed and profiled;
18. the epoch trainer: ``train_main`` on ``cuda`` over one task of the
   phase-9 corpus (batch 8, 2 epochs, Noam Adam at --warmup 4000); every
   Epoch and VALID loss finite, ``step_1``, ``step_2`` and ``best_model``
   written, a resume from ``step_2`` running the third epoch; one epoch
   step timed and profiled;
19. one f32 step of each of those paths on the card against the CPU, as
   phases 10 and 12 (a MAML step, an adversarial joint step, a multitask
   meta step, a Noam epoch step): loss, the model's and the
   discriminator's gradients, the params after the update; the f32 VGG
   kernels, the stack's backward and the STFT must launch;
20. trains the flagship width through ``meta_transfer_train_main`` on
   ``cuda`` with the training options on: ``--augment --noise-dir`` (two
   seeded noise recordings) ``--prefetch-workers 4 --device-cer
   --profile-dir``, 6 steps: every loss finite, the trace written, no
   prefetch thread alive afterwards, the FFT STFT, both bf16 VGG kernels
   and the stack's backward at least 2K a step; then one step's device CER
   against the host CER of its support hyps (equal), both timed, and the
   step timed and profiled;
21. ``train_main --feat_extractor emb_cnn --loss ctc`` (one task of 16
   utterances, batch 8, nesterov SGD, 2 epochs) and ``test_main`` greedy
   on its best model: the FFT STFT launched, the VGG kernels never; one
   epoch step timed and profiled;
22. ``joint_train_main --feat logfbank`` (vgg_cnn over 80 mel bins, 3
   steps) and ``test_main`` greedy on its best model: both bf16 VGG
   kernels launched, the STFT never; one joint step timed and profiled;
23. f32 parity, card against CPU: an emb_cnn CTC epoch step (loss,
   gradients, params after nesterov SGD, the BatchNorm running statistics
   after it), the log-fbank features, the device CER;
24. serves a seeded checkpoint at BASELINE.json configs[4]'s width (a
   17-block Conformer at d_model 1024, 8 heads, the decoder's d_k = d_v =
   128, d_inner 2048, d_emb 1024, 4 decoder layers, vgg_cnn, bf16) with
   ``test_main`` greedily over phase 6's 20 utterances in batches of 8: the
   FFT STFT and both bf16 VGG kernels once a batch; prints utterances/s;
25. trains that width by first-order meta-transfer with ``--remat``
   through ``meta_transfer_train_main`` (K 3 x (8 + 8) utterances of the
   phase-9 corpus, 3 steps): every loss finite, both bf16 VGG kernels and
   the stack's backward at least 2K a step, the FFT STFT K + 1; then one
   step timed and profiled (step ms, busy share, peak memory);
26. configs[4]'s training mode, ``--second-order --remat`` meta-transfer
   at that width through ``meta_transfer_train_main`` (K 3 x (8 + 8), 4
   steps): every loss finite, the FFT STFT K + 1 a step, no VGG kernel and
   no stack backward (second order takes the plain route); one step timed
   and profiled; then one second-order MAML step through
   ``meta_train_main`` at the flagship width;
27. f32 on the card against the CPU: one second-order meta step at the
   flagship width with ``--clip`` (loss, outer gradients, params after
   Adam, as phase 10), the Conformer encoder at configs[4]'s width; and
   ``--remat --remat-conv`` on against off at that width (bf16, dropout
   0.1: equal loss and generator state, gradients within one bf16 ulp of
   the largest);
28. trains the flagship width on a task mesh through
   ``meta_transfer_train_main --mesh-task 3`` (3 ranks sharing the card
   over gloo, each one task of 8 + 8 utterances; bf16, dropout 0, 3 steps)
   beside the same argv in one process: every loss finite and within 1e-3
   relative of the single process's; every rank launched the FFT STFT,
   both bf16 VGG kernels and the stack's backward (its counts gathered by
   the launcher); step ms beside the single process's, each rank's peak
   memory;
29. in one 2-rank group on the card: f32 sharded meta steps (first and
   second order) and an emb_cnn epoch step with its BatchNorm synchronized
   on (task 1, data 2) against the same steps in one process (outer
   gradients within 1e-4 of the largest); f32 tensor-parallel steps on
   (task 1, data 1, model 2) at the flagship width, each against one
   process: a first-order meta step, a second-order one with ``--clip``, a
   joint step, a Noam epoch step and a first-order meta step of a 2-block
   Conformer at configs[4]'s width (loss within 1e-5 relative, the
   gradients gathered to full within 1e-4 of the largest, the replicated
   leaves bitwise equal on both ranks after the update); the
   sequence-parallel encode of
   a batch of 2 utterances of 40-60 s on model 2 against the unsharded
   encode (bf16 within one bf16 ulp of the largest output, f32 within
   1e-5 of it, a 2-block Conformer at configs[4]'s width in bf16), each
   rank's VGG kernels launched once on its haloed slice, each rank's
   encode peak memory beside the unsharded encode's;
30. serves 4 utterances of 40-60 s through ``test_main --mesh-model 2``
   (bucket 6400 frames, ``--src-max-len 4000``) and the unsharded
   ``test_main``: PRED lines and finite totals, every rank launched the
   FFT STFT and both bf16 VGG kernels once a batch; utterances/s and peak
   memory by rank;
31. trains the flagship width tensor-parallel through
   ``meta_transfer_train_main --mesh-model 2`` (2 ranks sharing the card
   over gloo, each holding its slice of the split weights and their Adam
   moments) with phase 28's argv (bf16, dropout 0, K 3 x (8 + 8), 3 steps)
   beside phase 28's one-process run: every loss finite and within 1e-3
   relative of it; every rank launched the FFT STFT, both bf16 VGG kernels
   and the stack's backward (the replicated front-end; counts gathered by
   the launcher); step ms, each rank's peak memory, rank 0's bytes of
   params and moments beside the one process's;
32. the same at configs[4]'s width: ``meta_transfer_train_main
   --mesh-model 2 --remat`` with phase 25's flags, 2 steps: every loss
   finite, every rank's launches as in 31, step ms, each rank's peak
   memory beside phase 25's one-process peak;
33. prints the kernels as one JSON line (6 records: both STFT routes and
   the four VGG routes) and, last, the result line.

Phases 3b and 3c hold both routes of both VGG blocks against their plain
versions at the log-fbank shapes (80 bins into block 1, 40 into block 2)
and at the 22.05 kHz path's (221 into block 1, 110 into block 2), and
print their times beside phase 3's. Phase 3 also sums the cuFFT chain's
kernels' device time a call (torch.profiler), the yardstick of the direct
STFT's kernel alone.

``python3 chip_smoke.py --tp-scaling`` (four cards) runs ``tp_scaling``
alone after the build: first-order meta steps in one process and on
``--mesh-model`` 2 and 4 over NCCL, at the flagship width and at
configs[4]'s, and configs[4]'s on a task-3 and on a data-2 mesh.

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
# 22.05 kHz at the same 20 ms / 10 ms windows: the direct STFT route
SR_22K, N_FFT_22K, HOP_22K = 22050, 441, 220
# H100 SXM dense peaks (NVIDIA data sheet), at a 700 W power limit
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_TF32 = 495e12
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


def _device_total_ms(fn, iters=20):
    """Device time of all the kernels ``fn`` launches, summed per call, by
    torch.profiler, and the kernels a call: a library chain's work on the
    card without its launches' host time."""
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
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(times, "profiler saw no device work")
    return sum(times) / 1e3 / iters, len(times) / iters


def _bound_ms(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _bound_f32_gemm(nbytes, flops):
    """The bound of an f32 row in GEMM form (the direct STFT, both f32 VGG
    blocks): the larger of the bytes at 3.35 TB/s and the operations at the
    faster of f32 FMAs (67 TFLOP/s) and 3xTF32 (three passes at 495);
    returns (ms, bound_by, a note naming the term that binds)."""
    t_bytes = nbytes / PEAK_BYTES
    t_f32, t_tf32 = flops / PEAK_F32, 3 * flops / PEAK_TF32
    if t_bytes > min(t_f32, t_tf32):
        return t_bytes * 1e3, "bytes", f"{nbytes} B at 3.35 TB/s"
    term = ("3xTF32, three passes at 495 TFLOP/s" if t_tf32 <= t_f32
            else "f32 FMAs at 67 TFLOP/s")
    return (min(t_f32, t_tf32) * 1e3, "operations",
            f"{flops:.3e} flop, {term}")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernels(torch, dev):
    """Phase 3: each kernel against its plain version at the flagship
    shapes; returns the kernels' records (launches filled in later)."""
    import torch.nn.functional as F

    from mtl_tpu_torch.ops.stft import (WINDOWS, device_dft_matrices,
                                        device_dft_tc_operands,
                                        device_fft_tables, stft_logmag,
                                        stft_logmag_direct, stft_logmag_plain,
                                        stft_route)
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
    # (the 3xTF32 GEMM, for n_fft with a prime factor above 5 in its half)
    # runs through its launcher at the same shapes, in turns with it, for
    # continuity with its former CUDA-core design's times (PERF.md), and
    # at its own shape below
    s = (T - 1) * HOP + N_FFT
    audio = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (B, s)).astype(np.float32)).to(dev)
    cos_b, nsin_b = device_dft_matrices(N_FFT, "hamming", dev)
    packed = device_dft_tc_operands(N_FFT, "hamming", dev)
    win, tw = device_fft_tables(N_FFT, "hamming", dev)
    check(stft_route(N_FFT) == "fft", "n_fft 320 must take the FFT route")
    ref = stft_logmag_plain(audio, cos_b, nsin_b, T, HOP)
    routes = {  # name -> (call, kernel name for the profiler)
        "fft": (lambda: stft_logmag(audio, N_FFT, HOP, T, "hamming"),
                "stft_fft_kernel"),
        "direct": (lambda: stft_logmag_direct(audio, packed, N_FFT, T, HOP),
                   "stft_dft_tc_kernel"),
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
        # f32 on both sides (the direct route's 3xTF32 products to ~2^-22);
        # the sums run in other orders
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)

    def cufft_chain(a, n_fft, hop, window):
        """The same function and layout in one library chain (cuFFT)."""
        return torch.stft(a, n_fft, hop, window=window, center=False,
                          return_complex=True).abs().log1p().transpose(
                              1, 2).contiguous()

    lib_err = float((cufft_chain(audio, N_FFT, HOP, win) - ref).abs().max())
    torch.testing.assert_close(cufft_chain(audio, N_FFT, HOP, win), ref,
                               rtol=1e-4, atol=1e-4)
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
    library_ms = _time_ms(lambda: cufft_chain(audio, N_FFT, HOP, win))
    m = N_FFT // 2
    # the packed M-point complex FFT (5 M log2 M) and the split and
    # magnitude (~10 a bin), per frame; the GEMM form for the note
    fft_flops = B * T * (5 * m * math.log2(m) + 10 * NFREQ)
    gemm_flops = 4 * B * T * N_FFT * NFREQ
    nbytes = _nbytes(audio, win, tw, ref)
    bound, bound_by = _bound_ms(nbytes, fft_flops, PEAK_F32)
    fft_ms = sum(ms for ms, _ in by["fft"]) / 2
    fft_alone = [alone for _, alone in by["fft"]]
    direct_ms = sum(ms for ms, _ in by["direct"]) / 2
    direct_alone = sum(a for _, a in by["direct"]) / 2
    d_bound, _, d_note = _bound_f32_gemm(_nbytes(audio, packed, ref),
                                         gemm_flops)
    print("kernel stft_logmag turns (route, ms, kernel alone ms): "
          + "; ".join(f"{r} {ms:.4f} {a:.4f}" for r, ms, a in turns)
          + f"; fft alone {bound / min(fft_alone):.3f} of its bound; cuFFT "
          f"chain max_abs_err {lib_err:.3e}", flush=True)
    chain_dev, chain_n = _device_total_ms(
        lambda: cufft_chain(audio, N_FFT, HOP, win))
    print(f"kernel stft_logmag_direct at n_fft {N_FFT} (csrc/"
          f"stft_dft_tc.cu, 3xTF32): max_abs_err {errs['direct'][0]:.3e} "
          f"(the former CUDA-core design's: 2.4e-7); ms {direct_ms:.4f} "
          f"alone {direct_alone:.4f} library_ms {library_ms:.4f} (device "
          f"{chain_dev:.4f}, {chain_n:.1f} kernels a call) bound_ms "
          f"{d_bound:.4f} ({d_note}); alone {d_bound / direct_alone:.3f} of "
          f"its bound", flush=True)
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

    # the direct route at its own shape: 22.05 kHz, 20 ms / 10 ms windows
    n_fft, hop = N_FFT_22K, HOP_22K
    f = n_fft // 2 + 1
    check(stft_route(n_fft) == "direct", f"n_fft {n_fft} takes the direct "
                                         f"route")
    a22 = torch.from_numpy(rng.uniform(
        -0.5, 0.5, (B, (T - 1) * hop + n_fft)).astype(np.float32)).to(dev)
    cos22, nsin22 = device_dft_matrices(n_fft, "hamming", dev)
    packed22 = device_dft_tc_operands(n_fft, "hamming", dev)
    win22 = torch.from_numpy(WINDOWS["hamming"](n_fft)).to(dev)
    ref22 = stft_logmag_plain(a22, cos22, nsin22, T, hop)
    direct22 = lambda: stft_logmag(a22, n_fft, hop, T, "hamming")  # noqa
    out22 = direct22()
    torch.cuda.synchronize()
    check(out22.shape == ref22.shape == (B, T, f), "stft 22.05 kHz shape")
    check(bool(torch.isfinite(out22).all()), "stft 22.05 kHz not finite")
    d = (out22 - ref22).abs()
    err22 = (float(d.max()), float((d / ref22.abs().clamp_min(1e-6)).max()))
    torch.testing.assert_close(out22, ref22, rtol=1e-4, atol=1e-4)
    lib22 = lambda: cufft_chain(a22, n_fft, hop, win22)  # noqa: E731
    torch.testing.assert_close(lib22(), ref22, rtol=1e-4, atol=1e-4)
    # turns: kernel, library, library, kernel
    k_ms, l_ms = [], []
    for which in ("kernel", "library", "library", "kernel"):
        (k_ms if which == "kernel" else l_ms).append(
            _time_ms(direct22 if which == "kernel" else lib22))
    alone22 = _device_ms(direct22, "stft_dft_tc_kernel")
    # the chain's device time: its kernels summed, without the host's
    # launches, the yardstick of the kernel alone
    lib_dev22, lib_n22 = _device_total_ms(lib22)
    flops22 = 4 * B * T * n_fft * f
    bound22, by22, note22 = _bound_f32_gemm(_nbytes(a22, packed22, ref22),
                                            flops22)
    print(f"kernel stft_logmag_direct at n_fft {n_fft}, hop {hop} (B {B}, T "
          f"{T}, F {f}): turns kernel {k_ms[0]:.4f} / {k_ms[1]:.4f} ms, "
          f"cuFFT chain {l_ms[0]:.4f} / {l_ms[1]:.4f} ms; kernel alone "
          f"{alone22:.4f} ms against the chain's kernels {lib_dev22:.4f} ms "
          f"({lib_n22:.1f} a call, device time); "
          f"{bound22 / alone22:.3f} of its bound; "
          f"max_abs_err {err22[0]:.3e} (the former design's: 2.4e-7 at "
          f"n_fft 320)",
          flush=True)
    report({
        "name": "stft_logmag_direct", "route": "cuda",
        "source": "mtl_tpu_torch/csrc/stft_dft_tc.cu",
        "replaces": "mtl_tpu/ops/stft_pallas.py:59",
        "max_abs_err": err22[0], "ms": sum(k_ms) / 2,
        "plain_ms": _time_ms(lambda: stft_logmag_plain(a22, cos22, nsin22,
                                                       T, hop)),
        "library_ms": sum(l_ms) / 2, "bound_ms": bound22, "bound_by": by22,
        "_bound_note": note22, "_path": "serve22k",
    }, *err22, "rtol=atol=1e-4 (f32; 3xTF32 products, summation order)")

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
            # f32 on both sides (TF32 off; block 2's 3xTF32 products to
            # ~2^-22); the sums run in other orders
            tol = "rtol=atol=1e-4 (f32, summation order)"
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            bound, by, note = _bound_f32_gemm(_nbytes(x, *ws, out), flops)
            print(f"kernel {name}: max_abs_err {err:.3e} (the former "
                  f"CUDA-core design's: {FORMER_F32_ERR[name]})", flush=True)
            xl = (x.reshape(B, t_img, f_img, c_in).permute(0, 3, 1, 2)
                  .contiguous(memory_format=torch.channels_last))
            wl = [hwio_to_oihw(w).contiguous(
                memory_format=torch.channels_last) if w.dim() == 4 else w
                  for w in ws]
            # the f32 cuDNN chain in channels_last (TF32 off)
            library_ms = _time_ms(lambda: library(xl, *wl))
            source, kernel = F32_ROUTES[name]
            path = "parity"
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


FBANK_BINS = 80  # --feat logfbank: 80 mel bins into vgg_cnn
BINS_22K = N_FFT_22K // 2 + 1  # 221 STFT bins into vgg_cnn at 22.05 kHz
# the f32 VGG routes: source and kernel name; the max abs errors of their
# former CUDA-core design (PERF.md)
F32_ROUTES = {"vgg_block1_f32": ("mtl_tpu_torch/csrc/vgg_f32_tc.cu",
                                 "vgg_block1_f32tc_kernel"),
              "vgg_block2_f32": ("mtl_tpu_torch/csrc/vgg_f32_tc.cu",
                                 "vgg_block2_f32tc_kernel")}
FORMER_F32_ERR = {"vgg_block1_f32": "8.3e-7 at 161 bins, 8.9e-7 at 80",
               "vgg_block2_f32": "7.5e-7 at 161 bins, 1.2e-6 at 40"}


def check_kernels_width(torch, dev, bins, seed):
    """Phases 3b and 3c: both routes of both VGG blocks at another path's
    front-end width (batch 8, 800 frames x ``bins``; block 2 on block 1's
    output of the same route, 400 x bins // 2 x 64) against their plain
    versions, as phase 3 holds them at 161 bins, with the same tolerances,
    times (CUDA events), bounds and library chains."""
    import torch.nn.functional as F

    from mtl_tpu_torch.ops.vgg import (hwio_to_oihw, vgg_block1, vgg_block2,
                                       vgg_block_plain)

    rng = np.random.RandomState(seed)
    bf16, f32 = torch.bfloat16, torch.float32

    def weights(c_in, c):
        lim = math.sqrt(6.0 / (9 * c_in + 9 * c))
        ws = [rng.uniform(-lim, lim, (3, 3, c_in, c)),
              rng.randn(c) * 0.1,
              rng.uniform(-math.sqrt(3.0 / (9 * c)),
                          math.sqrt(3.0 / (9 * c)), (3, 3, c, c)),
              rng.randn(c) * 0.1]
        return [torch.from_numpy(w.astype(np.float32)).to(dev) for w in ws]

    x1 = torch.from_numpy(rng.randn(B, T, bins).astype(
        np.float32)).to(dev)
    w_1, w_2 = weights(1, 64), weights(64, 128)
    x2 = {d: vgg_block1(x1, *w_1, out_dtype=d) for d in (bf16, f32)}
    for name, fn, x, ws, c_in, c, dtype in (
            ("vgg_block1", vgg_block1, x1, w_1, 1, 64, bf16),
            ("vgg_block1_f32", vgg_block1, x1, w_1, 1, 64, f32),
            ("vgg_block2", vgg_block2, x2[bf16], w_2, 64, 128, bf16),
            ("vgg_block2_f32", vgg_block2, x2[f32], w_2, 64, 128, f32)):
        out = fn(x, *ws, out_dtype=dtype)
        ref = vgg_block_plain(x, *ws, out_dtype=dtype)
        torch.cuda.synchronize()
        t_img, f_img = x.shape[1], x.shape[2]
        check(out.shape == ref.shape == (B, t_img // 2, f_img // 2, c),
              f"{name} at {bins} bins: shape")
        d = (out.float() - ref.float()).abs()
        if dtype == bf16:  # one bf16 ulp, as phase 3
            bad = int((d > 2.0 ** -7 * ref.float().abs() + 2.0 ** -10).sum())
            check(bad == 0, f"{name} at {bins} bins: {bad} outside "
                            f"one bf16 ulp")
            peak, tol = PEAK_BF16, "one bf16 ulp"
        else:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            peak, tol = None, "rtol=atol=1e-4"
        flops = 2 * B * t_img * f_img * 9 * (c_in * c + c * c)
        if peak is None:  # the f32 rows' restated bound
            bound, by, _ = _bound_f32_gemm(_nbytes(x, *ws, out), flops)
        else:
            bound, by = _bound_ms(_nbytes(x, *ws, out), flops, peak)
        xl = (x.reshape(B, t_img, f_img, c_in).permute(0, 3, 1, 2).to(dtype)
              .contiguous(memory_format=torch.channels_last))
        wl = [hwio_to_oihw(w).to(dtype).contiguous(
            memory_format=torch.channels_last) if w.dim() == 4
              else w.to(dtype) for w in ws]

        def library():
            y = F.relu(F.conv2d(xl, wl[0], wl[1], padding=1))
            y = F.relu(F.conv2d(y, wl[2], wl[3], padding=1))
            return F.max_pool2d(y, 2)

        ms = _time_ms(lambda: fn(x, *ws, out_dtype=dtype))
        plain_ms = _time_ms(lambda: vgg_block_plain(x, *ws, out_dtype=dtype))
        alone = ""
        if dtype == f32:
            k_ms = _device_ms(lambda: fn(x, *ws, out_dtype=dtype),
                              F32_ROUTES[name][1])
            alone = (f"; alone {k_ms:.4f} ms, {bound / k_ms:.3f} of its "
                     f"bound; the former design's max_abs_err "
                     f"{FORMER_F32_ERR[name]}")
        print(f"kernel {name} at {bins} bins ([{B}, {t_img}, {f_img}"
              f"{'' if c_in == 1 else f', {c_in}'}]): max_abs_err "
              f"{float(d.max()):.3e} ({tol}); ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {_time_ms(library):.4f} bound_ms "
              f"{bound:.4f} ({by}){alone}", flush=True)


def flagship_config(name, save_folder, sample_rate=16000):
    """The flagship width (the defaults, spelled out: vgg_cnn, 2 enc / 4
    dec, d_model 512, 8 heads, d_k = d_v = 64, d_inner 512, d_emb 512, r
    100, bf16) at ``sample_rate``, finalized."""
    from mtl_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.feat_extractor, m.num_enc_layers, m.num_dec_layers = "vgg_cnn", 2, 4
    m.num_heads, m.dim_model, m.dim_key, m.dim_value = 8, 512, 64, 64
    m.dim_inner, m.dim_emb, m.r, m.dtype = 512, 512, 100, "bfloat16"
    cfg.audio.sample_rate = sample_rate
    cfg.name, cfg.save_folder = name, save_folder
    cfg.finalize()
    return cfg


def serve(torch, dev, corpus_dir, models_dir):
    """Phases 4-6: corpus, seeded flagship checkpoint, test_main on cuda.
    Returns (test_main's result, its stdout, wall seconds, seconds of audio
    served, launch counts, checkpoint path)."""
    from mtl_tpu_torch.cli.asr import test_main
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

    cfg = flagship_config("chip_smoke", models_dir)
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


def serve_22k(torch, dev, work):
    """Phase 6b: the direct STFT route on a served path. A corpus of 8
    synthetic utterances of 4-7.9 s at 22.05 kHz (n_fft 441, hop 220, 221
    bins); a seeded checkpoint at the flagship width at that rate (vgg_cnn
    sees 221 bins: dim_input (221 // 4) * 128); ``test_main`` on cuda, the
    counters zeroed before and read after: the direct STFT once a batch,
    the FFT STFT never, both bf16 VGG kernels once a batch. Then one batch's
    front-end on the card against the CPU's plain version (the raw
    log-magnitudes and the normalized features, rtol = atol = 1e-4). Phase
    3c holds both VGG blocks' routes at this path's widths (221 bins into
    block 1, 110 into block 2). Returns the served run's launch counts."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.ops.frontend import log_spectrogram
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    manifests, labels_path = make_synthetic_corpus(
        os.path.join(work, "corpus_22k"), num_tasks=1, utts_per_task=8,
        sample_rate=SR_22K, min_sec=4.0, max_sec=7.9, seed=SEED + 22)
    with open(labels_path, encoding="utf-8") as f:
        vocab = Vocab.from_labels(json.load(f))
    cfg = flagship_config("chip_smoke_22k", os.path.join(work, "models"),
                          SR_22K)
    a, m = cfg.audio, cfg.model
    check((a.n_fft, a.hop_length, a.num_freq, m.dim_input)
          == (N_FFT_22K, HOP_22K, BINS_22K, (BINS_22K // 4) * 128),
          f"22.05 kHz config: {a.n_fft} {a.hop_length} {a.num_freq} "
          f"{m.dim_input}")
    model = build_model(cfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(SEED))
    ckpt = save_checkpoint(cfg, vocab, model.state_dict(), step=0,
                           best_model=True)
    argv = ["--test-manifest-list", manifests[0], "--labels-path",
            labels_path, "--continue-from", ckpt, "--name", "chip_smoke_22k",
            "--device", dev.type, "--k-valid", "8", "--k-test", "8"]
    buf = io.StringIO()
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = test_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = dict(native.launch_counts)
    out = buf.getvalue()
    with open(os.path.join(work, "test_main_22k.txt"), "w",
              encoding="utf-8") as f:
        f.write(out)
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL CER")]
    preds = [ln for ln in out.splitlines() if ln.startswith("PRED:")]
    check(len(total) == 1 and len(preds) == 8 and result["utterances"] == 8
          and all(math.isfinite(result[k])
                  for k in ("cer", "wer", "en_cer", "zh_cer")),
          f"22.05 kHz run: {len(preds)} PRED lines, {len(total)} TOTAL lines")
    print(total[0], flush=True)
    print(f"22.05 kHz: served 8 utterances in {wall:.3f} s "
          f"({8 / wall:.3f} utterances/s); launches {counts}", flush=True)
    check(counts["stft_logmag_direct"] == 1 and counts["stft_logmag"] == 0
          and counts["vgg_block1"] == counts["vgg_block2"] == 1,
          f"the 22.05 kHz run must launch the direct STFT once a batch, the "
          f"FFT STFT never and each bf16 VGG kernel once a batch: {counts}")

    # one batch's front-end: kernel (card) against plain version (CPU)
    ds = SpectrogramDataset(vocab, cfg, manifests)
    batch = next(ds.iter_batches(8, shuffle=False))
    fronts = []
    for d in (dev, torch.device("cpu")):
        audio = torch.from_numpy(batch["audio"]).to(d)
        alen = torch.from_numpy(batch["audio_lengths"]).to(d)
        fronts.append([log_spectrogram(audio, alen, a.n_fft, a.hop_length,
                                       normalize=norm, prepadded=True)[0]
                       for norm in (False, True)])
    for what, card, cpu in zip(("log-magnitudes", "normalized features"),
                               *fronts):
        card = card.cpu()
        check(bool(torch.isfinite(card).all()), f"22.05 kHz {what}")
        print(f"22.05 kHz {what} {tuple(card.shape)}: card vs cpu "
              f"max_abs_err {float((card - cpu).abs().max()):.3e}",
              flush=True)
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-4)
    print(f"22.05 kHz phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


BEAM_W, BEAM_NBEST = 8, 5  # README.md's beam command


def build_lm(torch, dev, work):
    """An LM at lm_parser's defaults (LSTM, emsize 200, nhid 200, 2
    layers, untied), seeded, over the code-switched task of a synthetic
    word corpus; saved as a port LM checkpoint, tested on the card with the
    LM's test_main (its JSON line printed) and converted into a fusion
    directory with convert_main. Returns the fusion directory."""
    from mtl_tpu_torch.cli.lm import (build_lm, convert_main, lm_parser,
                                      save_lm_ckpt)
    from mtl_tpu_torch.cli.lm import test_main as lm_test_main
    from mtl_tpu_torch.data.synthetic import make_synthetic_lm_corpus
    from mtl_tpu_torch.lm.data import Corpus
    from mtl_tpu_torch.lm.model import init_lm_weights

    root = os.path.join(work, "lm")
    task = make_synthetic_lm_corpus(os.path.join(root, "corpus"),
                                    num_tasks=3, sentences_per_task=400,
                                    seed=SEED)[-1]
    train, test = (os.path.join(task, f"{s}.txt") for s in ("train", "test"))
    corpus = Corpus(train)
    with open(test, encoding="utf-8") as f:
        unseen = (set(f.read().lower().split())
                  - set(corpus.dictionary.word2idx))
    check(not unseen, f"LM test words outside the train dictionary: {unseen}")
    args = lm_parser("").parse_args([])
    lm = build_lm(args, len(corpus.dictionary))
    init_lm_weights(lm, torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(root, "ckpt")
    save_lm_ckpt(ckpt, lm, corpus.dictionary, args, len(corpus.dictionary))
    buf = io.StringIO()
    with contextlib.chdir(work), contextlib.redirect_stdout(buf):
        res = lm_test_main(["--load", ckpt, "--test_path", test,
                            "--name", "chip_smoke", "--device", dev.type])
        fusion = convert_main(["--load", ckpt, "--save",
                               os.path.join(root, "fusion"), "--device",
                               dev.type])
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(len(line) == 1 and math.isfinite(res["ppl"]),
          f"LM test_main: {buf.getvalue()[-500:]}")
    print(f"LM ({args.model}, emsize {args.emsize}, nhid {args.nhid}, "
          f"{args.nlayers} layers, {len(corpus.dictionary)} words, "
          f"seeded) test_main on {dev.type}: {line[0]}", flush=True)
    return fusion


def serve_beam(torch, dev, ckpt, manifest, labels_path, fusion):
    """The beam phase: test_main --beam-search --beam-width 8
    --beam-nbest 5 --lm-rescoring on cuda (README's command) with the
    launch counters zeroed before and read after. Returns (result, stdout,
    wall seconds, launch counts, peak MiB)."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.ops import native

    argv = ["--test-manifest-list", manifest, "--labels-path", labels_path,
            "--continue-from", ckpt, "--name", "chip_smoke_beam",
            "--device", dev.type, "--k-valid", "8", "--k-test", "8",
            "--beam-search", "--beam-width", str(BEAM_W), "--beam-nbest",
            str(BEAM_NBEST), "--lm-rescoring", "--lm-path", fusion]
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = test_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(native.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    return result, buf.getvalue(), wall, counts, peak


def beam_batch(torch, dev, ckpt, manifest, fusion):
    """One served beam batch (B 8, 800 frames) taken apart: the decode
    loop timed and its steps counted, the LM scoring of its bank timed,
    then the whole batch under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mtl_tpu_torch.cli.common import load_asr_model
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.decode.beam import (NEG_INF, beam_decode_ids,
                                           beam_search_grouped)
    from mtl_tpu_torch.lm.fusion import LMScorer
    from mtl_tpu_torch.models.subsampler import subsampled_length
    from mtl_tpu_torch.train.steps import prepare_features
    from mtl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, vocab, sd, _, _ = load_checkpoint(ckpt)
    model = load_asr_model(cfg, vocab, sd, dev)
    lm = LMScorer.load(fusion, dev)
    ds = SpectrogramDataset(vocab, cfg, [manifest], normalize=True)
    batch, _ = next(ds.iter_batches(8, shuffle=False, with_valid_count=True))
    steps = [0]
    step_fn = model.decode_step

    def counted(*a):
        steps[0] += 1
        return step_fn(*a)

    model.decode_step = counted
    n_bank = max(BEAM_NBEST, BEAM_W) * 4
    with torch.inference_mode():
        feats, lengths = prepare_features(
            {k: torch.from_numpy(batch[k]).to(dev)
             for k in ("audio", "audio_lengths")}, cfg)
        horizon = min(cfg.decode.max_steps, subsampled_length(
            cfg.model.feat_extractor, feats.shape[1]))
        kw = dict(beam_width=BEAM_W, nbest=BEAM_NBEST, max_steps=horizon,
                  start_token=vocab.SOS_ID, c_weight=0.1, lm=lm,
                  lm_rescoring=True, lm_weight=0.1)
        beam_search_grouped(model, feats, lengths, vocab, **kw)  # warm
        torch.cuda.synchronize()
        steps[0] = 0
        t0 = time.perf_counter()
        toks, scores, _, lens = beam_decode_ids(
            model, feats, lengths, BEAM_W, horizon, vocab.SOS_ID, n_bank,
            vocab.label2id.get(" ", -1), 0.1)
        toks, scores, lens = toks.cpu(), scores.cpu(), lens.cpu()
        dec_ms = (time.perf_counter() - t0) * 1e3
        id_lists = [[vocab.SOS_ID] + toks[x, j, :lens[x, j]].tolist()
                    for x in range(toks.shape[0]) for j in range(n_bank)
                    if scores[x, j] > NEG_INF / 2]
        t0 = time.perf_counter()
        lm.score_batch(id_lists, vocab)
        lm_ms = (time.perf_counter() - t0) * 1e3
        print(f"beam batch (B 8, W {BEAM_W}, bank {n_bank}, horizon "
              f"{horizon}): decode loop {steps[0]} steps in {dec_ms:.3f} "
              f"ms, {dec_ms / max(steps[0], 1):.3f} ms per beam step (host "
              f"clock, synchronized, encoder and cross K/V included); LM "
              f"scoring of {len(id_lists)} sequences in one call "
              f"{lm_ms:.3f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            beam_search_grouped(model, feats, lengths, vocab, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = _busy_ms(events, torch)
    by_name = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in events)
    launches = sum("LaunchKernel" in e.name for e in events)
    print(f"profiled beam batch: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, busy share {busy / wall_ms:.4f}; {kernels} "
          f"device ops ({kernels / max(steps[0], 1):.1f} a beam step), "
          f"{launches} kernel-launch API calls", flush=True)
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:10]:
        print(f"  top device op {t:9.3f} ms  {name[:110]}", flush=True)
    return dec_ms / max(steps[0], 1)


def beam_parity(torch, dev, ckpt, manifest, fusion):
    """The beam at f32 on the card (kernels, f32 routes) against the CPU
    (plain versions): same weights, B 2 cut to 400 frames, W 3, 10 steps,
    the fusion LM. Bank tokens, lengths and word counts equal, raw scores
    within 1e-4; the LM's scores of the bank's hypotheses within 1e-5,
    on the card in one call with TF32 allowed globally (the LM holds
    itself to f32), on the CPU one sequence at a time. Returns the card
    run's launch counts."""
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.decode.beam import NEG_INF, beam_decode_ids
    from mtl_tpu_torch.lm.fusion import LMScorer
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.train.steps import prepare_features
    from mtl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, vocab, sd, _, _ = load_checkpoint(ckpt)
    cfg.model.dtype = "float32"
    ds = SpectrogramDataset(vocab, cfg, [manifest])
    batch = next(ds.iter_batches(2, shuffle=False, force_frames=400))
    banks = []  # [card, cpu]
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
            banks.append([x.cpu() for x in beam_decode_ids(
                model, feats, lengths, 3, 10, vocab.SOS_ID, 0,
                vocab.label2id.get(" ", -1), 0.1)])
            if d == dev:
                torch.cuda.synchronize()
                counts = dict(native.launch_counts)
    (ct, cs, cw, cl), (pt, ps, pw, pl) = banks
    real = ps > NEG_INF / 2
    if not (torch.equal(ct, pt) and torch.equal(cl, pl)
            and torch.equal(cw, pw)):
        for x in range(ct.shape[0]):
            for j in range(ct.shape[1]):
                print(f"beam parity mismatch row {x} slot {j}: card "
                      f"{ct[x, j, :cl[x, j]].tolist()} raw {float(cs[x, j])}"
                      f"; cpu {pt[x, j, :pl[x, j]].tolist()} raw "
                      f"{float(ps[x, j])}", flush=True)
        raise RuntimeError("chip_smoke check failed: beam banks differ "
                           "between the card and the CPU")
    check(torch.equal(cs > NEG_INF / 2, real), "bank slots differ")
    err = float((cs[real] - ps[real]).abs().max())
    torch.testing.assert_close(cs[real], ps[real], rtol=1e-4, atol=1e-4)
    id_lists = [[vocab.SOS_ID] + pt[x, j, :pl[x, j]].tolist()
                for x in range(pt.shape[0]) for j in range(pt.shape[1])
                if real[x, j]]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = LMScorer.load(fusion, dev).score_batch(id_lists, vocab)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    cpu_lm = LMScorer.load(fusion, torch.device("cpu"))
    lm_err = 0.0
    for ids, got in zip(id_lists, card):
        want = cpu_lm.score_ids(ids, vocab)
        check(got[1:] == want[1:], f"LM word/OOV counts {got} vs {want}")
        lm_err = max(lm_err, abs(got[0] - want[0]))
    check(lm_err <= 1e-5, f"LM scores differ by {lm_err}")
    print(f"beam parity (f32, B 2, 400 frames, W 3, 10 steps): "
          f"{int(real.sum())} bank hypotheses, tokens/lengths/words equal, "
          f"raw max_abs_err {err:.3e}; LM score_ids of them card (one "
          f"call, TF32 allowed) vs cpu max_abs_err {lm_err:.3e}",
          flush=True)
    return counts


TRAIN_FLAGS = [  # the flagship width (the CLI's defaults differ)
    "--feat_extractor", "vgg_cnn", "--num-enc-layers", "2",
    "--num-dec-layers", "4", "--num-heads", "8", "--dim-model", "512",
    "--dim-key", "64", "--dim-value", "64", "--dim-inner", "512",
    "--dim-emb", "512", "--r", "100", "--dtype", "bfloat16"]
K_TASKS, K_SHOT, TRAIN_STEPS = 3, 8, 6


class _Recorder:
    """An optimizer that keeps the gradients and moves nothing (a step's
    gradients, read out)."""

    @staticmethod
    def init(params):
        return None

    def update(self, grads, state, params):
        self.grads = {k: g.detach().float().cpu() for k, g in grads.items()}
        return state


class _Recording:
    """``inner`` (an optimizer) that keeps the gradients it is handed, on
    their device."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.inner.update(grads, state, params)


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
    """Phase 9. Returns (launch counts of the main run, corpus dir, models
    dir)."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.train.optim import make_meta_optimizers
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    corpus = os.path.join(work, "train_corpus")
    manifests, labels = make_synthetic_corpus(
        corpus, num_tasks=K_TASKS, utts_per_task=16, min_sec=4.0,
        max_sec=7.9, seed=SEED + 1)
    models = os.path.join(work, "train_models")
    # the meta trainer's outer optimizer is Adam whatever --opt_name says;
    # the flag is kept in the checkpoint's config, which is what a finetune
    # from it reads (phase 11 finetunes with nesterov SGD)
    argv = _asr_train_argv(dev, manifests, labels, models) + [
        "--opt_name", "sgd"]
    state, out, wall, counts = _run_cli(
        torch, meta_transfer_train_main, argv + ["--epochs",
                                                 str(TRAIN_STEPS)],
        work, "chip_train")
    _finite_losses(out, TRAIN_STEPS, "train run")
    check(state.step == TRAIN_STEPS, f"trained {state.step} steps")
    for tag in ("step_3", "step_6", "best_model"):
        for name in ("model.pt", "train_state.pt", "meta.json"):
            check(os.path.exists(os.path.join(models, "chip_train", tag,
                                              name)), f"{tag}/{name}")
    per_it = _per_iteration(out)
    print(f"train run: {TRAIN_STEPS} meta steps (K {K_TASKS}, {K_SHOT} + "
          f"{K_SHOT} utterances, bf16) in {wall:.3f} s with 2 evaluations "
          f"and 3 checkpoints; TOTAL TIME per iteration after the first "
          f"(host clock, batch to device + step + train CER): median "
          f"{per_it:.3f} ms", flush=True)
    print(f"launches in the train run: {counts}", flush=True)
    ran = _host_steps(counts, TRAIN_STEPS)
    need = 2 * K_TASKS * ran
    check(all(counts[k] >= need for k in ("vgg_block1", "vgg_block2",
                                          "vgg_stack_bwd"))
          and counts["stft_logmag"] >= (K_TASKS + 1) * ran
          and counts["stft_logmag_direct"] == 0
          and counts["meta_graph_replays"] >= 1,
          f"the train run must replay the step at least once, launch each "
          f"VGG kernel and the backward >= {need} times in the {ran} steps "
          f"that ran on the host, the FFT STFT >= {(K_TASKS + 1) * ran}, "
          f"the direct STFT never: {counts}")

    # resume from the last checkpoint: iterations 7 and 8
    state, out, _, _ = _run_cli(
        torch, meta_transfer_train_main, argv + [
            "--epochs", str(TRAIN_STEPS + 2), "--continue-from",
            os.path.join(models, "chip_train", "step_6")],
        work, "chip_train_resume")
    its = [int(x) for x in re.findall(r"\(Iteration (\d+)\) TRAIN LOSS",
                                      out)]
    check(its == [TRAIN_STEPS + 1, TRAIN_STEPS + 2]
          and state.opt_state.count == TRAIN_STEPS + 2,
          f"resume ran iterations {its}, Adam count {state.opt_state.count}")
    print(f"resume from step_6: iterations {its}, Adam count "
          f"{state.opt_state.count}", flush=True)

    # one meta step, timed and profiled on device-side batches
    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_train_timing")
    batches = [[batch_to_device(b, dev) for b in ds.sample_meta_batch(
        K_SHOT, K_SHOT)] for _ in range(6)]
    _, opt = make_meta_optimizers(cfg)
    state = init_train_state(model, opt)
    step = make_meta_step(model, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    it = iter(batches)
    wall_ms, by_name, prof = _time_and_profile(
        torch, "meta step",
        lambda: float(step(state, *next(it, batches[-1]), gen)[1][
            "outer_loss"]),
        f"flagship, bf16, K {K_TASKS}, {K_SHOT}+{K_SHOT}, "
        f"{batches[0][0]['audio'].shape[-1]} samples a row")
    events = prof.events()
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
    return counts, corpus, models


def _host_steps(counts, steps):
    """How many of a meta run's ``steps`` ran the step's host code, which
    counts the kernels: a step replayed as a CUDA graph launches them
    uncounted, and a capture counts them once, for itself and its first
    replay."""
    return (steps - counts["meta_graph_replays"]
            + counts["meta_graph_captures"])


GRAPH_KEYS = [(800, 128), (800, 128), (1600, 256), (1600, 256), (800, 128)]
CONFORMER_GRAPH_KEYS = [(800, 128)] * 3 + [(2500, 256)] * 3 + [(800, 128)]


def _graph_batches(ds, keys):
    """Host meta batches (support [K, B, ...], the shared query) forced to
    the (frames, labels) buckets of ``keys``."""
    out = []
    for frames, labels in keys:
        sup = [ds._collate(ds.sample_pairs(K_SHOT, m), frames, labels)
               for m in range(K_TASKS)]
        out.append(({k: np.stack([b[k] for b in sup]) for k in sup[0]},
                    ds._collate(ds.sample_pairs(K_SHOT, K_TASKS - 1),
                                frames, labels)))
    return out


def _graph_step_run(torch, dev, cfg, vocab, weights, batches, graphed):
    """Meta steps over the host ``batches`` from ``weights``, each run from
    an empty cache and the allocator's peaks reset: the eager step (each
    batch copied to the card first) or ``GraphedMetaStep``. Returns
    (metrics by step, the final weights and Adam moments, all on the host;
    per step (seconds, reserved peak bytes); the graphs' pool's reserved
    bytes (0 eager); launch counts with each replay's kernels added)."""
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.train.graphs import GraphedMetaStep
    from mtl_tpu_torch.train.optim import make_meta_optimizers
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, len(vocab), dev)
    model.load_state_dict(weights)
    _, opt = make_meta_optimizers(cfg)
    state = init_train_state(model, opt)
    step = (GraphedMetaStep(model, cfg, opt, dev) if graphed
            else make_meta_step(model, cfg, opt))
    gen = torch.Generator(dev).manual_seed(SEED)
    native.reset_launch_counts()
    metrics, per_step = [], []
    for support, query in batches:
        t0 = time.perf_counter()
        if not graphed:
            support, query = (batch_to_device(b, dev) for b in (support,
                                                                query))
        state, m = step(state, support, query, gen)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0,
                         torch.cuda.max_memory_reserved()))
        metrics.append({k: v.cpu() for k, v in m.items()})
    counts = dict(native.launch_counts)
    pool = 0
    if graphed:
        pool = step.pool.reserved_bytes()
        for e in step.entries.values():
            for k, n in e.launches.items():
                counts[k] += n * (e.replays - 1)
    final = {group: {n: t.detach().cpu() for n, t in ts.items()}
             for group, ts in (("param", state.params),
                               ("mu", state.opt_state.mu),
                               ("nu", state.opt_state.nu))}
    del model, state, step, m
    _free(torch)
    return metrics, final, per_step, pool, counts


def graph_checks(torch, dev, corpus):
    """Phase 9b (module docstring)."""
    argv = _asr_train_argv(dev, [os.path.join(corpus,
                                              f"manifest_task{i}.csv")
                                 for i in range(K_TASKS)],
                           os.path.join(corpus, "labels.json"),
                           os.path.join(WORK, "graph_models"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                    "chip_graph_parity")
        weights = {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}
        del model
        batches = _graph_batches(ds, GRAPH_KEYS)
        want, w_final, _, _, c0 = _graph_step_run(torch, dev, cfg, vocab,
                                                  weights, batches, False)
        got, g_final, _, pool, c1 = _graph_step_run(torch, dev, cfg, vocab,
                                                    weights, batches, True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    worst, exact = 0.0, True
    pairs = [(f"step {i + 1} {k}", w[k], g[k])
             for i, (w, g) in enumerate(zip(want, got)) for k in w]
    pairs += [(f"{group} {n}", w_final[group][n], g_final[group][n])
              for group in w_final for n in w_final[group]]
    for what, w, g in pairs:
        if torch.equal(w, g):
            continue
        exact = False
        check(w.is_floating_point(), f"graph parity: {what} differs")
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        worst = max(worst, err / scale if scale else math.inf)
    check(worst <= 2.0 ** -8, f"graph parity: worst error {worst:.3e} of "
          f"the largest element, above one bf16 ulp")
    replays = c1.pop("meta_graph_replays")
    captures = c1.pop("meta_graph_captures")
    check(c0.pop("meta_graph_replays") == c0.pop("meta_graph_captures") == 0
          and (captures, replays) == (2, 3) and c0 == c1,
          f"graph parity launches: eager {c0}, graphed with each replay's "
          f"kernels {c1}, {captures} captures, {replays} replays")
    print(f"graph parity (flagship, bf16, keys {GRAPH_KEYS}): bit-equal "
          f"{exact}, worst error {worst:.3e} of the largest element; "
          f"{captures} captures, {replays} replays, launches {c1}; pool "
          f"{pool / 2**30:.3f} GiB", flush=True)

    argv = _conformer_argv(dev, corpus, os.path.join(WORK, "graph_models"))
    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_graph_memory")
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    del model
    batches = _graph_batches(ds, CONFORMER_GRAPH_KEYS)
    peaks = {}
    for graphed in (False, True):
        _, _, per_step, pool, _ = _graph_step_run(torch, dev, cfg, vocab,
                                                  weights, batches, graphed)
        what = "graphed" if graphed else "eager"
        peaks[what] = per_step[-1][1]
        print(f"graph memory, configs[4] width, {what}: " + ", ".join(
            f"{f}x{lab} {sec:.3f} s {res / 2**30:.2f} GiB"
            for (f, lab), (sec, res) in zip(CONFORMER_GRAPH_KEYS, per_step))
            + f"; reserved peak {peaks[what] / 2**30:.3f} GiB, pool "
            f"{pool / 2**30:.3f} GiB", flush=True)
    check(peaks["graphed"] <= 1.1 * peaks["eager"],
          f"graph memory: the graphed run reserved "
          f"{peaks['graphed'] / 2**30:.3f} GiB, the eager run "
          f"{peaks['eager'] / 2**30:.3f} GiB")


def _asr_train_argv(dev, manifests, labels, models):
    """The training CLIs' flags of phases 9 and 11: the flagship width,
    K = 3 tasks of 8 utterances, dropout 0.1, one 800-frame bucket, an
    evaluation and a checkpoint every 3 iterations."""
    return (["--train-manifest-list", *manifests, "--valid-manifest-list",
             manifests[-1], "--labels-path", labels, "--device", dev.type,
             "--k-train", str(K_SHOT), "--k-valid", str(K_SHOT),
             "--evaluate-every", "3", "--save-every", "3", "--dropout", "0.1",
             "--save-folder", models, "--src-buckets", "800"] + TRAIN_FLAGS)


def _parity_inputs(torch, corpus):
    """The f32 parity checks' inputs: (config at f32 with dropout 0, vocab,
    support of 2 tasks x 2 utterances at 400 frames, query of 2, weights
    with nonzero conv biases, MAML's queries: 2 tasks x 2, drawn last)."""
    from mtl_tpu_torch.config import build_parser, config_from_args
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights

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
    own = [ds._collate(ds.sample_pairs(2, i), 400, 64) for i in (0, 1)]
    queries = {k: np.stack([b[k] for b in own]) for k in own[0]}
    return cfg, vocab, support, query, weights, queries


def _step_parity(torch, dev, cfg, vocab, weights, run, opts, what):
    """One f32 step on the card (kernels) against the CPU (plain versions)
    from ``weights``: ``run(model, opt, device) -> loss`` once with a
    gradient recorder and once with each optimizer of ``opts`` ((name, lr,
    factory), ...). Checks the loss, the gradients and the params after
    each update; returns the card's launch counts of its last run."""
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.ops import native

    runs = (("grads", None, _Recorder),) + opts
    res = []  # [card, cpu]
    for d in (dev, torch.device("cpu")):
        out = {}
        for name, _, make in runs:
            model = build_model(cfg, len(vocab), d)
            model.load_state_dict(weights)
            opt = make()
            if d == dev and name == runs[-1][0]:
                torch.cuda.synchronize()
                native.reset_launch_counts()
            loss = run(model, opt, d)
            # a run with a discriminator also returns its gradients (the
            # grads run) or its params after its plain SGD step
            loss, out[f"{name}_disc"] = (loss if isinstance(loss, tuple)
                                         else (loss, None))
            out[f"{name}_loss"] = float(loss)
            out[name] = opt.grads if name == "grads" else {
                k: v.detach().cpu() for k, v in model.named_parameters()}
            if d == dev and name == runs[-1][0]:
                torch.cuda.synchronize()
                counts = dict(native.launch_counts)
        res.append(out)
    card, cpu = res
    for name, _, _ in runs:
        key = f"{name}_loss"
        print(f"{what} parity {key}: card {card[key]:.7f} cpu {cpu[key]:.7f}",
              flush=True)
        check(math.isclose(card[key], cpu[key], rel_tol=1e-3),
              f"{what} loss card {card[key]} cpu {cpu[key]}")
    scale = max(float(g.abs().max()) for g in cpu["grads"].values())
    gerr = max(float((card["grads"][k] - g).abs().max())
               for k, g in cpu["grads"].items())
    # f32 on both sides, TF32 off: summation order only
    for k, g in cpu["grads"].items():
        torch.testing.assert_close(card["grads"][k], g, rtol=1e-3,
                                   atol=1e-3 * scale)
    notes = []
    if cpu["grads_disc"] is not None:
        dg = cpu["grads_disc"]
        dscale = max(float(g.abs().max()) for g in dg.values())
        derr = max(float((card["grads_disc"][k] - g).abs().max())
                   for k, g in dg.items())
        for k, g in dg.items():
            torch.testing.assert_close(card["grads_disc"][k], g, rtol=1e-3,
                                       atol=1e-3 * dscale)
        lr_disc = cfg.train.lr_disc
        for name, _, _ in opts:
            perr = max(float((card[f"{name}_disc"][k] - p).abs().max())
                       for k, p in cpu[f"{name}_disc"].items())
            check(perr <= lr_disc * 1e-3 * dscale + 1e-7,
                  f"{what} discriminator after SGD differs by {perr}")
        notes.append(f"discriminator grads max_abs_err {derr:.3e} of max "
                     f"{dscale:.3e}, params after its SGD (lr {lr_disc}) "
                     f"max_abs_err {perr:.3e}")
    for name, lr, _ in opts:
        perr, checked = 0.0, 0
        for k, p in cpu[name].items():
            d = (card[name][k] - p).abs()
            if name == "sgd":
                # nesterov's first step moves by lr * 1.9 g
                sure = torch.ones_like(d, dtype=torch.bool)
                check(float(d.max()) <= lr * 1.9 * 1e-3 * scale + 1e-8,
                      f"{what} sgd {k} differs by {float(d.max())}")
            else:
                # Adam's first step moves each weight by about lr * sign(g);
                # entries whose gradient is below 1e-3 of the largest may
                # take either sign on either side, the rest must agree to
                # 0.1 lr
                check(float(d.max()) <= 2 * lr + 1e-7,
                      f"{what} {k} moved {float(d.max())}")
                sure = cpu["grads"][k].abs() > 1e-3 * scale
            if sure.any():
                perr = max(perr, float(d[sure].max()))
                checked += int(sure.sum())
        if name != "sgd":
            check(perr <= 0.1 * lr, f"{what} post-{name} params differ by "
                                    f"{perr}")
        notes.append(f"params after {name} (lr {lr}) max_abs_err {perr:.3e} "
                     f"over {checked} entries")
    print(f"{what} parity (f32, 2 tasks x 2 utterances, 400 frames): "
          f"grads max_abs_err {gerr:.3e} of max {scale:.3e}; "
          + "; ".join(notes), flush=True)
    return counts


def train_parity(torch, dev, corpus):
    """Phase 10: one f32 meta step on the card (kernels) against the CPU
    (plain versions): outer loss and gradients, and params after Adam (the
    entries with |g| > 1e-3 of the largest). Returns the card run's launch
    counts."""
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    cfg, vocab, support, query, weights, _ = _parity_inputs(torch, corpus)
    lr = cfg.train.meta_lr

    def run(model, opt, d):
        state = init_train_state(model, opt)
        _, m = make_meta_step(model, cfg, opt)(
            state, batch_to_device(support, d), batch_to_device(query, d))
        return m["outer_loss"]

    counts = _step_parity(torch, dev, cfg, vocab, weights, run,
                          (("adam", lr, lambda: Adam(lr)),), "train")
    print(f"launches in the f32 train parity run: {counts}", flush=True)
    check(all(counts[k] >= 4 for k in ("vgg_block1_f32", "vgg_block2_f32",
                                       "vgg_stack_bwd")),
          f"the f32 step must run the f32 VGG kernels and the backward: "
          f"{counts}")
    return counts


def _time_steps(torch, fn, n):
    """ms of ``n`` calls of ``fn``, each ended by a synchronize (host
    clock)."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _profile_once(torch, fn, host=True):
    """One call of ``fn`` under torch.profiler: (wall ms, device busy ms,
    device ms by kernel name, the profiler's events). ``host=False``
    records the device's kernels alone (a step of ~10^5 host ops takes
    the profiler tens of seconds to read back)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    by_name = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return wall_ms, _busy_ms(events, torch), by_name, prof


def _by_group(by_name):
    groups = {}
    for name, t in by_name.items():
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS
                  if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + t
    return "; ".join(f"{g} {t:.3f}" for g, t in sorted(
        groups.items(), key=lambda x: -x[1]))


JOINT_STEPS, FINETUNE_STEPS = 6, 3


def joint(torch, dev, work, corpus, meta_models):
    """Phase 11: joint training at the flagship width through
    ``joint_train_main`` on cuda (Adam, K 3 x 8 utterances, bf16, dropout
    0.1, 6 iterations, an evaluation and a checkpoint every 3), the counts
    zeroed before and read after; ``finetune_main`` from phase 9's meta
    checkpoint (its config says nesterov SGD, so the Adam state is left and
    the weights alone restored) for 3 iterations; then one joint step
    timed on device-side batches, its peak memory and one profiled step.
    Returns the launch counts of the joint run."""
    from mtl_tpu_torch.cli.asr import finetune_main, joint_train_main
    from mtl_tpu_torch.train.optim import SGDState, make_joint_optimizer
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step)

    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    labels = os.path.join(corpus, "labels.json")
    models = os.path.join(work, "joint_models")
    argv = _asr_train_argv(dev, manifests, labels, models)
    state, out, wall, counts = _run_cli(
        torch, joint_train_main, argv + ["--epochs", str(JOINT_STEPS)],
        work, "chip_joint")
    _finite_losses(out, JOINT_STEPS, "joint run")
    check(state.step == JOINT_STEPS, f"joint trained {state.step} steps")
    for tag in ("step_3", "step_6", "best_model"):
        for name in ("model.pt", "train_state.pt", "meta.json"):
            check(os.path.exists(os.path.join(models, "chip_joint", tag,
                                              name)), f"joint {tag}/{name}")
    print(f"joint run: {JOINT_STEPS} joint steps (K {K_TASKS} x {K_SHOT} "
          f"utterances, bf16, Adam) in {wall:.3f} s with 2 evaluations and 3 "
          f"checkpoints; TOTAL TIME per iteration after the first (host "
          f"clock, batch to device + step + train CER): median "
          f"{_per_iteration(out):.3f} ms", flush=True)
    _check_counts(counts, K_TASKS * JOINT_STEPS, "joint run")

    # finetune from the meta checkpoint: iterations 7-9 by nesterov SGD
    state, out, _, _ = _run_cli(
        torch, finetune_main, argv + [
            "--epochs", str(TRAIN_STEPS + FINETUNE_STEPS), "--opt_name",
            "sgd", "--continue-from",
            os.path.join(meta_models, "chip_train", "step_6")],
        work, "chip_finetune")
    its = [int(x) for x in re.findall(r"\(Iteration (\d+)\) TRAIN LOSS",
                                      out)]
    losses = [float(x) for x in re.findall(r"TRAIN LOSS:(\S+)", out)]
    check(its == list(range(TRAIN_STEPS + 1,
                            TRAIN_STEPS + FINETUNE_STEPS + 1))
          and all(map(math.isfinite, losses))
          and "RESTORED STATE" in out
          and isinstance(state.opt_state, SGDState)
          and state.opt_state.trace is not None
          and state.step == FINETUNE_STEPS,
          f"finetune ran iterations {its}, losses {losses}, step "
          f"{state.step}, state {type(state.opt_state).__name__}")
    print(f"finetune from the meta checkpoint step_6: iterations {its} by "
          f"nesterov SGD, weights restored alone (the Adam state does not "
          f"fit SGD), step {state.step}", flush=True)

    # one joint step, timed and profiled on device-side batches
    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_joint_timing")
    batches = [batch_to_device(ds.sample_meta_batch(K_SHOT, 1)[0], dev)
               for _ in range(6)]
    opt = make_joint_optimizer(cfg)
    state = init_train_state(model, opt)
    step = make_joint_step(model, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    it = iter(batches)
    _time_and_profile(
        torch, "joint step",
        lambda: float(step(state, next(it, batches[-1]), gen)[1]),
        f"flagship, bf16, Adam, K {K_TASKS} x {K_SHOT}, "
        f"{batches[0]['audio'].shape[-1]} samples a row")
    return counts


def joint_parity(torch, dev, corpus):
    """Phase 12: one f32 joint step on the card (kernels) against the CPU
    (plain versions): loss and gradients, and params after Adam and after
    nesterov SGD. Returns the card run's launch counts."""
    from mtl_tpu_torch.train.optim import SGD, Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step)

    cfg, vocab, support, _, weights, _ = _parity_inputs(torch, corpus)
    lr = cfg.train.lr

    def run(model, opt, d):
        state = init_train_state(model, opt)
        return make_joint_step(model, cfg, opt)(
            state, batch_to_device(support, d))[1]

    counts = _step_parity(
        torch, dev, cfg, vocab, weights, run,
        (("adam", lr, lambda: Adam(lr)),
         ("sgd", lr, lambda: SGD(lr, cfg.train.momentum, nesterov=True))),
        "joint")
    print(f"launches in the f32 joint parity run: {counts}", flush=True)
    check(all(counts[k] >= 2 for k in ("vgg_block1_f32", "vgg_block2_f32",
                                       "vgg_stack_bwd")),
          f"the f32 joint step must run the f32 VGG kernels and the "
          f"backward: {counts}")
    return counts



def _run_cli(torch, main, argv, work, name):
    """Runs a training entry point with the launch counters zeroed just
    before and read just after; writes its output to ``<work>/<name>.txt``
    and prints its TRAIN/VALID/Meta-test/Epoch lines. Returns (its
    result, its output, wall seconds, launch counts)."""
    from mtl_tpu_torch.ops import native

    buf = io.StringIO()
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv + ["--name", name])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(native.launch_counts)
    out = buf.getvalue()
    with open(os.path.join(work, f"{name}.txt"), "w", encoding="utf-8") as f:
        f.write(out)
    for ln in out.splitlines():
        if ln.startswith(("(Iteration", "(Meta-test)", "(Epoch")):
            print(f"{name}: {ln}", flush=True)
    return result, out, wall, counts


def _per_iteration(out):
    """The median ms between successive TOTAL TIME stamps of a run's
    TRAIN lines after the first (host clock: batch to device, step, train
    CER)."""
    totals = [float(x) for x in re.findall(r"TOTAL TIME:(\S+)", out)]
    per_it = sorted(b - a for a, b in zip(totals, totals[1:]))
    return per_it[len(per_it) // 2] * 1e3


def _finite_losses(out, n, what, evaluated=True):
    """The TRAIN LOSS values of ``out``; there must be ``n``, all finite,
    and (a run that ``evaluated``) VALID losses, all finite too."""
    losses = [float(x) for x in re.findall(r"TRAIN LOSS:(\S+)", out)]
    valid = [float(x) for x in re.findall(r"VALID (?:SET \d+ )?LOSS:(\S+)",
                                          out)]
    check(len(losses) == n and all(map(math.isfinite, losses + valid))
          and bool(valid) == evaluated,
          f"{what}: losses {losses}, valid {valid}")
    return losses


def _check_counts(counts, need, what, forward=("vgg_block1", "vgg_block2",
                                                "vgg_stack_bwd",
                                                "stft_logmag")):
    """Each kernel of ``forward`` launched at least ``need`` times, the
    direct STFT and the f32 VGG kernels never (a bf16 run)."""
    check(all(counts[k] >= need for k in forward)
          and counts["stft_logmag_direct"] == 0
          and counts["vgg_block1_f32"] == counts["vgg_block2_f32"] == 0,
          f"{what} must launch {forward} >= {need} times each, the direct "
          f"STFT and the f32 VGG kernels never: {counts}")
    print(f"launches in the {what}: {counts}", flush=True)


def _time_and_profile(torch, what, fn, n_batches_note, n=5, host=True):
    """Times ``n`` calls of ``fn`` (host clock, each ended by a
    synchronize; median after the first), the peak memory beside what was
    allocated before the first call (earlier phases' garbage collected
    first), and profiles one more."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    ms = _time_steps(torch, fn, n)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    steady = sorted(ms[1:])
    median = (steady[(n - 2) // 2] + steady[(n - 1) // 2]) / 2
    print(f"{what} ({n_batches_note}): " + ", ".join(f"{v:.3f}" for v in ms)
          + f" ms; median after the first {median:.3f} "
          f"ms; peak memory {peak:.1f} MiB ({held:.1f} MiB allocated before "
          f"the first step: weights, batches)", flush=True)
    wall_ms, busy, by_name, prof = _profile_once(torch, fn, host)
    print(f"profiled {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} "
          f"ms, busy share {busy / wall_ms:.4f}; device ms by group: "
          f"{_by_group(by_name)}", flush=True)
    return wall_ms, by_name, prof


def _train_corpus_setup(torch, dev, corpus, argv, name):
    """(config, vocab, train set over the corpus's 3 tasks, seeded model
    on ``dev``) at the flags of ``argv``."""
    from mtl_tpu_torch.config import build_parser, config_from_args
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights

    cfg = config_from_args(build_parser("").parse_args(argv + [
        "--name", name]))
    with open(os.path.join(corpus, "labels.json"), encoding="utf-8") as f:
        vocab = Vocab.from_labels(json.load(f))
    ds = SpectrogramDataset(vocab, cfg, cfg.data.train_manifest_list,
                            is_train=True, seed=SEED)
    model = build_model(cfg, len(vocab), dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return cfg, vocab, ds, model


MAML_STEPS, MULTITASK_STEPS, EPOCHS = 6, 3, 2


def maml(torch, dev, work, corpus):
    """Phase 16: MAML at the flagship width through ``meta_train_main`` on
    cuda (bf16, dropout 0.1; 3 tasks of 8 support + 8 own-query
    utterances, 6 iterations, an evaluation and a checkpoint every 3, then
    ``--num-meta-test 2``), the counts zeroed before and read after: every
    support and query forward runs the FFT STFT and both bf16 VGG kernels,
    every backward the stack's recompute (each >= 2K a step); then one
    MAML step timed and profiled. Returns the launch counts of the run."""
    from mtl_tpu_torch.cli.asr import meta_train_main
    from mtl_tpu_torch.train.optim import make_meta_optimizers
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    labels = os.path.join(corpus, "labels.json")
    models = os.path.join(work, "maml_models")
    argv = _asr_train_argv(dev, manifests, labels, models)
    state, out, wall, counts = _run_cli(
        torch, meta_train_main, argv + ["--epochs", str(MAML_STEPS),
                                        "--num-meta-test", "2"],
        work, "chip_maml")
    _finite_losses(out, MAML_STEPS, "MAML run")
    meta = re.findall(r"\(Meta-test\) trials=2 AVG LOSS:(\S+) AVG CER", out)
    check("Meta Trainer is initialized" in out and len(meta) == 1
          and math.isfinite(float(meta[0])) and state.step == MAML_STEPS,
          f"MAML run: step {state.step}, Meta-test {meta}")
    for tag in ("step_3", "step_6", "best_model"):
        check(os.path.exists(os.path.join(models, "chip_maml", tag,
                                          "train_state.pt")), f"maml {tag}")
    print(f"MAML run: {MAML_STEPS} steps (K {K_TASKS}, {K_SHOT} + {K_SHOT} "
          f"own-query utterances a task, bf16) with 2 evaluations, 3 "
          f"checkpoints and 2 meta-test trials in {wall:.3f} s", flush=True)
    _check_counts(counts, 2 * K_TASKS * _host_steps(counts, MAML_STEPS),
                  "MAML run")

    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_maml_timing")
    batches = [[batch_to_device(b, dev) for b in ds.sample_meta_batch(
        K_SHOT, K_SHOT, per_task_query=True)] for _ in range(6)]
    _, opt = make_meta_optimizers(cfg)
    state = init_train_state(model, opt)
    step = make_meta_step(model, cfg, opt, per_task_query=True)
    gen = torch.Generator(dev).manual_seed(SEED)
    it = iter(batches)
    _time_and_profile(
        torch, "MAML step",
        lambda: float(step(state, *next(it, batches[-1]), gen)[1][
            "outer_loss"]),
        f"flagship, bf16, K {K_TASKS}, {K_SHOT}+{K_SHOT} own-query, "
        f"{batches[0][0]['audio'].shape[-1]} samples a row")
    return counts


def disc_heads(torch, dev, work, corpus):
    """Phase 17: the discriminator heads at the flagship width on cuda:
    ``joint_train_main --adversarial --beta-decay`` for 6 iterations and
    ``meta_transfer_train_main --multitask`` for 3 (counts zeroed before
    and read after each), a ``--continue-from`` of the joint run to
    iterations 7-8 with its discriminator and both optimizer states
    restored, ``test_main`` serving the disc-trained checkpoint; then one
    adversarial joint step timed and profiled. Returns the launch counts
    of the joint run."""
    from mtl_tpu_torch.cli.asr import (joint_train_main,
                                       meta_transfer_train_main, test_main)
    from mtl_tpu_torch.models.discriminator import Discriminator
    from mtl_tpu_torch.train.optim import make_joint_optimizer
    from mtl_tpu_torch.train.steps import batch_to_device, init_train_state
    from mtl_tpu_torch.train.steps_disc import (DiscTrainState,
                                                init_disc_state,
                                                make_joint_step_disc)

    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    labels = os.path.join(corpus, "labels.json")
    models = os.path.join(work, "disc_models")
    argv = _asr_train_argv(dev, manifests, labels, models)
    state, out, wall, counts = _run_cli(
        torch, joint_train_main, argv + ["--epochs", str(JOINT_STEPS),
                                         "--adversarial", "--beta-decay"],
        work, "chip_adversarial")
    _finite_losses(out, JOINT_STEPS, "adversarial joint run")
    check(isinstance(state, DiscTrainState) and state.step == JOINT_STEPS
          and state.disc_opt_state.count == JOINT_STEPS,
          f"adversarial run: {type(state).__name__}, step {state.step}")
    print(f"adversarial joint run: {JOINT_STEPS} steps in {wall:.3f} s",
          flush=True)
    _check_counts(counts, K_TASKS * JOINT_STEPS, "adversarial joint run")

    mstate, out, wall, mcounts = _run_cli(
        torch, meta_transfer_train_main, argv + [
            "--epochs", str(MULTITASK_STEPS), "--multitask"], work,
        "chip_multitask")
    _finite_losses(out, MULTITASK_STEPS, "multitask meta run")
    check(isinstance(mstate, DiscTrainState)
          and mstate.disc_opt_state.count == MULTITASK_STEPS,
          f"multitask run: {type(mstate).__name__}")
    print(f"multitask meta run: {MULTITASK_STEPS} steps in {wall:.3f} s",
          flush=True)
    _check_counts(mcounts, 2 * K_TASKS * MULTITASK_STEPS,
                  "multitask meta run",
                  forward=("vgg_block1", "vgg_block2", "vgg_stack_bwd"))
    check(mcounts["stft_logmag"] >= (K_TASKS + 1) * MULTITASK_STEPS,
          f"multitask run STFT launches: {mcounts}")

    ckpt = os.path.join(models, "chip_adversarial", "step_6")
    rstate, out, _, _ = _run_cli(
        torch, joint_train_main, argv + ["--epochs", str(JOINT_STEPS + 2),
                                         "--continue-from", ckpt],
        work, "chip_adversarial_resume")
    its = [int(x) for x in re.findall(r"\(Iteration (\d+)\) TRAIN LOSS",
                                      out)]
    check(its == [JOINT_STEPS + 1, JOINT_STEPS + 2]
          and isinstance(rstate, DiscTrainState)
          and rstate.opt_state.count == JOINT_STEPS + 2
          and rstate.disc_opt_state.count == JOINT_STEPS + 2,
          f"adversarial resume ran {its}, counts "
          f"{rstate.opt_state.count}/{rstate.disc_opt_state.count}")
    print(f"adversarial resume from step_6: iterations {its}, model and "
          f"discriminator Adam counts {rstate.opt_state.count} / "
          f"{rstate.disc_opt_state.count}", flush=True)
    res, out, wall, _ = _run_cli(
        torch, test_main, ["--test-manifest-list", manifests[-1],
                           "--labels-path", labels, "--continue-from",
                           os.path.join(models, "chip_adversarial",
                                        "best_model"),
                           "--device", dev.type, "--k-test", "8"],
        work, "chip_adversarial_test")
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL CER")]
    check(res["utterances"] == 16 and len(total) == 1,
          f"test_main on the disc checkpoint: {res}")
    print(f"test_main serves the disc-trained best_model: {total[0]}",
          flush=True)

    cfg, vocab, ds, model = _train_corpus_setup(
        torch, dev, corpus, argv + ["--adversarial"], "chip_adv_timing")
    batches = [batch_to_device(ds.sample_meta_batch(K_SHOT, 1)[0], dev)
               for _ in range(6)]
    disc = Discriminator(cfg.model.dim_model, cfg.train.num_class).to(dev)
    opt = make_joint_optimizer(cfg)
    state = init_disc_state(disc, cfg, init_train_state(model, opt))
    step = make_joint_step_disc(model, disc, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    it = iter(batches)
    _time_and_profile(
        torch, "adversarial joint step",
        lambda: float(step(state, next(it, batches[-1]), gen, 0.5)[1]),
        f"flagship, bf16, Adam, K {K_TASKS} x {K_SHOT}")
    return counts


def epochs(torch, dev, work, corpus):
    """Phase 18: the epoch trainer through ``train_main`` on cuda at the
    flagship width over one task of the phase-9 corpus (16 utterances,
    batches of 8), 2 epochs, Noam Adam at --warmup 4000;
    every Epoch and VALID loss finite, ``step_1``, ``step_2`` and
    ``best_model`` written, a resume from ``step_2`` runs epoch 2 (the
    third); then one epoch step timed. Returns the launch counts."""
    from mtl_tpu_torch.cli.asr import train_main
    from mtl_tpu_torch.data.dataset import read_manifest
    from mtl_tpu_torch.train.optim import make_epoch_optimizer
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step)

    manifest = os.path.join(corpus, "manifest_task0.csv")
    labels = os.path.join(corpus, "labels.json")
    models = os.path.join(work, "epoch_models")
    argv = _asr_train_argv(dev, [manifest], labels, models)
    argv[argv.index("--valid-manifest-list") + 1] = os.path.join(
        corpus, "manifest_task2.csv")
    argv += ["--batch-size", str(K_SHOT), "--warmup", "4000"]
    per_epoch = -(-len(read_manifest(manifest)) // K_SHOT)
    state, out, wall, counts = _run_cli(
        torch, train_main, argv + ["--epochs", str(EPOCHS)], work,
        "chip_epoch")
    losses = [float(x) for x in re.findall(r"\(Epoch \d+\) TRAIN LOSS:(\S+)",
                                           out)]
    valid = [float(x) for x in re.findall(r"AVG VALID LOSS:(\S+)", out)]
    check(len(losses) == len(valid) == EPOCHS
          and all(map(math.isfinite, losses + valid))
          and state.step == per_epoch * EPOCHS
          and state.opt_state.schedule_count == per_epoch * EPOCHS,
          f"epoch run: losses {losses}, valid {valid}, step {state.step}")
    for tag in ("step_1", "step_2", "best_model"):
        check(os.path.exists(os.path.join(models, "chip_epoch", tag,
                                          "train_state.pt")), f"epoch {tag}")
    print(f"epoch run: {EPOCHS} epochs of {per_epoch} batches of {K_SHOT} "
          f"(Noam Adam, warmup 4000) in {wall:.3f} s", flush=True)
    _check_counts(counts, per_epoch * EPOCHS, "epoch run")
    rstate, out, _, _ = _run_cli(
        torch, train_main, argv + ["--epochs", str(EPOCHS + 1),
                                   "--continue-from", os.path.join(
                                       models, "chip_epoch", "step_2")],
        work, "chip_epoch_resume")
    check(re.findall(r"\(Epoch (\d+)\) TRAIN", out) == [str(EPOCHS)]
          and rstate.opt_state.schedule_count == per_epoch * (EPOCHS + 1),
          f"epoch resume: {out[-300:]}")
    print(f"epoch resume from step_2: epoch {EPOCHS} ran, Noam count "
          f"{rstate.opt_state.schedule_count}", flush=True)

    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_epoch_timing")
    batches = [batch_to_device({k: v[None] for k, v in b.items()}, dev)
               for b in ds.iter_batches(K_SHOT)]
    opt = make_epoch_optimizer(cfg)
    state = init_train_state(model, opt)
    step = make_joint_step(model, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    k = iter(range(100))
    _time_and_profile(
        torch, "epoch step",
        lambda: float(step(state, batches[next(k) % len(batches)], gen)[1]),
        f"flagship, bf16, Noam Adam, batch {K_SHOT}")
    return counts


def maml_disc_epoch_parity(torch, dev, corpus):
    """Phase 19: one f32 step of phases 16-18's paths on the card (kernels)
    against the CPU (plain versions) from the same weights and batches, as
    phases 10 and 12: a MAML step (2 tasks with their own queries), an
    adversarial joint step and a multitask meta step (the discriminator's
    gradients read out and its params after plain SGD, ``--opt_name
    sgd``), a Noam epoch step (one task's batch). Returns the card runs'
    launch counts."""
    from mtl_tpu_torch.models.discriminator import (Discriminator,
                                                    init_discriminator)
    from mtl_tpu_torch.train.optim import SGD, Adam, make_epoch_optimizer
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step, make_meta_step)
    from mtl_tpu_torch.train.steps_disc import DiscHead, init_disc_state

    cfg, vocab, support, query, weights, queries = _parity_inputs(torch,
                                                                  corpus)
    cfg.train.opt_name, cfg.train.lr_disc = "sgd", 1e-4
    disc0 = Discriminator(cfg.model.dim_model, cfg.train.num_class)
    init_discriminator(disc0, torch.Generator().manual_seed(SEED + 3))
    dweights = {k: v.clone() for k, v in disc0.state_dict().items()}
    lr, meta_lr = cfg.train.lr, cfg.train.meta_lr

    def disc_run(kind):
        def run(model, opt, d):
            cfg.train.adversarial = kind == "adversarial"
            cfg.train.multitask = kind == "multitask"
            disc = Discriminator(cfg.model.dim_model,
                                 cfg.train.num_class).to(d)
            state = init_disc_state(disc, cfg, init_train_state(model, opt))
            disc.load_state_dict(dweights)
            head = DiscHead(disc, cfg)
            if isinstance(opt, _Recorder):
                head.optimizer = _Recorder()
            sup = batch_to_device(support, d)
            if kind == "adversarial":
                loss = make_joint_step(model, cfg, opt, head=head)(
                    state, sup, None, 0.5)[1]
            else:
                loss = make_meta_step(model, cfg, opt, head=head)(
                    state, sup, batch_to_device(query, d))[1]["outer_loss"]
            disc_out = (head.optimizer.grads
                        if isinstance(head.optimizer, _Recorder) else
                        {k: v.detach().cpu()
                         for k, v in disc.state_dict().items()})
            return loss, disc_out
        return run

    def maml_run(model, opt, d):
        state = init_train_state(model, opt)
        return make_meta_step(model, cfg, opt, per_task_query=True)(
            state, batch_to_device(support, d),
            batch_to_device(queries, d))[1]["outer_loss"]

    def epoch_run(model, opt, d):
        state = init_train_state(model, opt)
        return make_joint_step(model, cfg, opt)(
            state, {k: v[:1] for k, v in batch_to_device(support,
                                                         d).items()})[1]

    noam_lr = make_epoch_optimizer(cfg).schedule(0)
    counts = {}
    for what, run, opts in (
            ("maml", maml_run, (("adam", meta_lr, lambda: Adam(meta_lr)),)),
            ("adversarial joint", disc_run("adversarial"),
             (("sgd", lr, lambda: SGD(lr, cfg.train.momentum,
                                      nesterov=True)),)),
            ("multitask meta", disc_run("multitask"),
             (("adam", meta_lr, lambda: Adam(meta_lr)),)),
            ("noam epoch", epoch_run,
             (("noam", noam_lr, lambda: make_epoch_optimizer(cfg)),))):
        counts[what] = _step_parity(torch, dev, cfg, vocab, weights, run,
                                    opts, what)
        print(f"launches in the f32 {what} parity run: {counts[what]}",
              flush=True)
        check(all(counts[what][k] >= 1 for k in (
            "vgg_block1_f32", "vgg_block2_f32", "vgg_stack_bwd",
            "stft_logmag")),
              f"the f32 {what} step must run the f32 VGG kernels, the "
              f"backward and the STFT: {counts[what]}")
    return counts


# -- the training options, emb_cnn + CTC and the log-fbank front-end -------

OPTION_STEPS, CTC_EPOCHS, FBANK_STEPS = 6, 2, 3


def _noise_dir(work):
    """Two seeded noise recordings (3 s and 1.5 s of 16 kHz noise) for
    --noise-dir."""
    from mtl_tpu_torch.data.synthetic import write_wav

    root = os.path.join(work, "noise")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED + 5)
    for i, sec in enumerate((3.0, 1.5)):
        write_wav(os.path.join(root, f"noise{i}.wav"),
                  rng.uniform(-0.3, 0.3, int(sec * 16000)))
    return root


def _prefetch_threads():
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith("prefetch") and t.is_alive()]


def options(torch, dev, work, corpus):
    """Phase 20: ``meta_transfer_train_main`` at the flagship width on
    cuda with ``--augment --noise-dir --prefetch-workers 4 --device-cer
    --profile-dir`` for 6 steps, the counts zeroed before and read after:
    every loss finite, the trace written, no prefetch thread alive after
    the run, the FFT STFT, both bf16 VGG kernels and the stack's backward
    at least 2K a step. Then one meta step with --device-cer: its device
    CER equals the host CER of its support hyps; the device CER's and the
    host CER's ms; the step timed and profiled. Returns the launch
    counts."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.ops.edit_distance import device_cer
    from mtl_tpu_torch.train.optim import make_meta_optimizers
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)
    from mtl_tpu_torch.train.trainer import batch_cer

    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    labels = os.path.join(corpus, "labels.json")
    profile = os.path.join(work, "options_profile")
    argv = _asr_train_argv(dev, manifests, labels,
                           os.path.join(work, "options_models")) + [
        "--augment", "--noise-dir", _noise_dir(work), "--prefetch-workers",
        "4", "--device-cer", "--profile-dir", profile]
    state, out, wall, counts = _run_cli(
        torch, meta_transfer_train_main, argv + ["--epochs",
                                                 str(OPTION_STEPS)],
        work, "chip_options")
    _finite_losses(out, OPTION_STEPS, "options run")
    traces = [f for f in os.listdir(profile) if f.endswith(".json")]
    alive = _prefetch_threads()
    check(state.step == OPTION_STEPS and len(traces) == 1
          and f"PROFILE written to {profile}" in out and not alive,
          f"options run: step {state.step}, traces {traces}, prefetch "
          f"threads alive {alive}")
    print(f"options run: {OPTION_STEPS} meta steps with augmentation, noise, "
          f"4 prefetch workers, the device CER and a profile "
          f"({os.path.getsize(os.path.join(profile, traces[0])) / 2**20:.1f}"
          f" MiB trace) in {wall:.3f} s; TOTAL TIME per iteration after the "
          f"first: median {_per_iteration(out):.3f} ms; no prefetch thread "
          f"alive after it", flush=True)
    ran = _host_steps(counts, OPTION_STEPS)
    _check_counts(counts, 2 * K_TASKS * ran, "options run",
                  forward=("vgg_block1", "vgg_block2", "vgg_stack_bwd"))
    check(counts["stft_logmag"] >= (K_TASKS + 1) * ran,
          f"options run STFT launches: {counts}")

    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_options_timing")
    batches = [[batch_to_device(b, dev) for b in ds.sample_meta_batch(
        K_SHOT, K_SHOT)] for _ in range(6)]
    _, opt = make_meta_optimizers(cfg)
    state = init_train_state(model, opt)
    space = vocab.label2id.get(" ")
    step = make_meta_step(model, cfg, opt, space_id=space)
    gen = torch.Generator(dev).manual_seed(SEED)
    _, m = step(state, *batches[0], gen)
    hyp, gold = m["support_hyp"], m["support_gold"]
    host = batch_cer(hyp.cpu().numpy(), gold.cpu().numpy(), vocab)
    dev_cer = (int(m["cer_dist"]), int(m["cer_chars"]))
    check(dev_cer == host, f"device CER {dev_cer} != host CER {host}")
    flat = (hyp.flatten(0, 1), gold.flatten(0, 1))
    cer_ms = _time_ms(lambda: device_cer(*flat, space))
    t0 = time.perf_counter()
    for _ in range(20):
        batch_cer(hyp.cpu().numpy(), gold.cpu().numpy(), vocab)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"device CER of a step's support hyps ({hyp.shape[0]} x "
          f"{hyp.shape[1]} rows of {hyp.shape[2]} ids): {dev_cer} equals the "
          f"host CER; device_cer {cer_ms:.4f} ms (CUDA events, 20 calls), "
          f"host batch_cer {host_ms:.4f} ms (host clock, copies to the host "
          f"included)", flush=True)
    it = iter(batches)
    _time_and_profile(
        torch, "meta step with --device-cer",
        lambda: int(step(state, *next(it, batches[-1]), gen)[1]["cer_dist"]),
        f"flagship, bf16, K {K_TASKS}, {K_SHOT}+{K_SHOT}, augmented and "
        f"noised batches")
    return counts


def _with_flag(argv, flag, value):
    argv = list(argv)
    argv[argv.index(flag) + 1] = value
    return argv


def emb_cnn_ctc(torch, dev, work, corpus):
    """Phase 21: ``train_main --feat_extractor emb_cnn --loss ctc`` on cuda
    at the flagship width over one task of the phase-9 corpus (16
    utterances, batches of 8, nesterov SGD), 2 epochs, then ``test_main``
    greedy on its best model; the counts zeroed before and read after
    each: the FFT STFT launched and the VGG kernels never. Then one epoch
    step timed and profiled. Returns the training run's launch counts."""
    from mtl_tpu_torch.cli.asr import test_main, train_main
    from mtl_tpu_torch.data.dataset import read_manifest
    from mtl_tpu_torch.train.optim import SGD, make_epoch_optimizer
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step)

    manifest = os.path.join(corpus, "manifest_task0.csv")
    labels = os.path.join(corpus, "labels.json")
    models = os.path.join(work, "ctc_models")
    argv = _with_flag(_asr_train_argv(dev, [manifest], labels, models),
                      "--feat_extractor", "emb_cnn")
    argv = _with_flag(argv, "--valid-manifest-list",
                      os.path.join(corpus, "manifest_task2.csv"))
    argv += ["--batch-size", str(K_SHOT), "--loss", "ctc", "--lr", "1e-3"]
    per_epoch = -(-len(read_manifest(manifest)) // K_SHOT)
    state, out, wall, counts = _run_cli(
        torch, train_main, argv + ["--epochs", str(CTC_EPOCHS)], work,
        "chip_emb_cnn_ctc")
    losses = [float(x) for x in re.findall(r"\(Epoch \d+\) TRAIN LOSS:(\S+)",
                                           out)]
    valid = [float(x) for x in re.findall(r"AVG VALID LOSS:(\S+)", out)]
    check(len(losses) == len(valid) == CTC_EPOCHS
          and all(map(math.isfinite, losses + valid))
          and state.step == per_epoch * CTC_EPOCHS
          and isinstance(state.opt_state.trace, dict),
          f"emb_cnn + CTC run: losses {losses}, valid {valid}, step "
          f"{state.step}")
    vgg = [k for k in ("vgg_block1", "vgg_block2", "vgg_block1_f32",
                       "vgg_block2_f32", "vgg_stack_bwd") if counts[k]]
    check(counts["stft_logmag"] >= per_epoch * CTC_EPOCHS and not vgg
          and counts["stft_logmag_direct"] == 0,
          f"the emb_cnn run must launch the FFT STFT and no VGG kernel: "
          f"{counts}")
    print(f"emb_cnn + CTC run: {CTC_EPOCHS} epochs of {per_epoch} batches "
          f"of {K_SHOT} (nesterov SGD) in {wall:.3f} s; launches {counts}",
          flush=True)
    res, out, wall, tcounts = _run_cli(
        torch, test_main, ["--test-manifest-list", manifest,
                           "--labels-path", labels, "--continue-from",
                           os.path.join(models, "chip_emb_cnn_ctc",
                                        "best_model"),
                           "--device", dev.type, "--k-test", str(K_SHOT)],
        work, "chip_emb_cnn_ctc_test")
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL CER")]
    check(res["utterances"] == 16 and len(total) == 1
          and tcounts["stft_logmag"] == per_epoch
          and not any(tcounts[k] for k in ("vgg_block1", "vgg_block2")),
          f"test_main on the emb_cnn checkpoint: {res}, {tcounts}")
    print(f"test_main serves the emb_cnn + CTC checkpoint in {wall:.3f} s: "
          f"{total[0]}; launches {tcounts}", flush=True)

    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_ctc_timing")
    batches = [batch_to_device({k: v[None] for k, v in b.items()}, dev)
               for b in ds.iter_batches(K_SHOT)]
    opt = make_epoch_optimizer(cfg)
    check(isinstance(opt, SGD) and opt.nesterov, "CTC's epoch optimizer")
    state = init_train_state(model, opt)
    step = make_joint_step(model, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    k = iter(range(100))
    _time_and_profile(
        torch, "emb_cnn + CTC epoch step",
        lambda: float(step(state, batches[next(k) % len(batches)], gen)[1]),
        f"flagship width, emb_cnn, bf16, nesterov SGD, batch {K_SHOT}")
    return counts


def log_fbank(torch, dev, work, corpus):
    """Phase 22: ``joint_train_main --feat logfbank`` on cuda at the
    flagship width (vgg_cnn over 80 mel bins, Adam, K 3 x 8), 3 steps,
    then ``test_main`` greedy on its best model; the counts zeroed before
    and read after each: both bf16 VGG kernels (and the backward) launched,
    the STFT never. Then one joint step timed and profiled. Returns the
    training run's launch counts."""
    from mtl_tpu_torch.cli.asr import joint_train_main, test_main
    from mtl_tpu_torch.train.optim import make_joint_optimizer
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step)

    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    labels = os.path.join(corpus, "labels.json")
    models = os.path.join(work, "fbank_models")
    argv = _asr_train_argv(dev, manifests, labels, models) + [
        "--feat", "logfbank"]
    state, out, wall, counts = _run_cli(
        torch, joint_train_main, argv + ["--epochs", str(FBANK_STEPS)], work,
        "chip_log_fbank")
    _finite_losses(out, FBANK_STEPS, "log-fbank joint run")
    stft = counts["stft_logmag"] + counts["stft_logmag_direct"]
    check(state.step == FBANK_STEPS and stft == 0
          and all(counts[k] >= K_TASKS * FBANK_STEPS
                  for k in ("vgg_block1", "vgg_block2", "vgg_stack_bwd")),
          f"the log-fbank run must launch both bf16 VGG kernels and the "
          f"backward >= K a step and the STFT never: {counts}")
    print(f"log-fbank joint run: {FBANK_STEPS} steps (K {K_TASKS} x "
          f"{K_SHOT}, 80 mel bins) in {wall:.3f} s; launches {counts}",
          flush=True)
    res, out, wall, tcounts = _run_cli(
        torch, test_main, ["--test-manifest-list", manifests[-1],
                           "--labels-path", labels, "--continue-from",
                           os.path.join(models, "chip_log_fbank",
                                        "best_model"),
                           "--device", dev.type, "--k-test", str(K_SHOT)],
        work, "chip_log_fbank_test")
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL CER")]
    check(res["utterances"] == 16 and len(total) == 1
          and tcounts["vgg_block1"] == tcounts["vgg_block2"] == 2
          and tcounts["stft_logmag"] + tcounts["stft_logmag_direct"] == 0,
          f"test_main on the log-fbank checkpoint: {res}, {tcounts}")
    print(f"test_main serves the log-fbank checkpoint in {wall:.3f} s: "
          f"{total[0]}; launches {tcounts}", flush=True)

    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                "chip_fbank_timing")
    batches = [batch_to_device(ds.sample_meta_batch(K_SHOT, 1)[0], dev)
               for _ in range(6)]
    opt = make_joint_optimizer(cfg)
    state = init_train_state(model, opt)
    step = make_joint_step(model, cfg, opt)
    gen = torch.Generator(dev).manual_seed(SEED)
    it = iter(batches)
    _time_and_profile(
        torch, "log-fbank joint step",
        lambda: float(step(state, next(it, batches[-1]), gen)[1]),
        f"flagship, bf16, Adam, K {K_TASKS} x {K_SHOT}, 80 mel bins")
    return counts


def slice_parity(torch, dev, corpus):
    """Phase 23: f32 on the card (kernels) against the CPU: an emb_cnn CTC
    epoch step (nesterov SGD) as phases 10 and 12 (loss, gradients, params
    after the update) and its BatchNorm running statistics after it
    (rtol/atol 1e-4 of the largest); the log-fbank features of a batch
    (f32 DFT and mel products, TF32 off: rtol/atol 1e-4, the log values
    reach -15.9); the device CER of random ids (equal). Returns the CTC
    run's launch counts."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.ops.edit_distance import device_cer
    from mtl_tpu_torch.train.optim import SGD
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step, prepare_features)

    cfg, vocab, support, _, _, _ = _parity_inputs(torch, corpus)
    cfg = Config.from_dict(json.loads(cfg.to_json()))
    cfg.model.feat_extractor, cfg.train.loss = "emb_cnn", "ctc"
    cfg.finalize()
    ref = build_model(cfg, len(vocab))
    init_weights(ref, torch.Generator().manual_seed(SEED + 4))
    g = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():  # trained running statistics are not 0 and 1
        for mean, var in ref.conv.batch_stats():
            mean.copy_(torch.randn(mean.shape, generator=g) * 0.3)
            var.uniform_(0.5, 2.0, generator=g)
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    lr = cfg.train.lr
    stats = []  # after each run: the card's, then the CPU's

    def run(model, opt, d):
        state = init_train_state(model, opt)
        loss = make_joint_step(model, cfg, opt)(
            state, {k: v[:1] for k, v in batch_to_device(support,
                                                         d).items()})[1]
        stats.append([t.detach().cpu() for pair in model.conv.batch_stats()
                      for t in pair])
        return loss

    counts = _step_parity(torch, dev, cfg, vocab, weights, run, (
        ("sgd", lr, lambda: SGD(lr, cfg.train.momentum, nesterov=True)),),
        "emb_cnn CTC epoch")
    serr = 0.0
    for a, b in zip(stats[0], stats[-1]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
        serr = max(serr, float((a - b).abs().max()))
    check(counts["stft_logmag"] >= 1 and not any(
        counts[k] for k in ("vgg_block1", "vgg_block2", "vgg_block1_f32",
                            "vgg_block2_f32")),
          f"the emb_cnn step must run the STFT and no VGG kernel: {counts}")
    print(f"emb_cnn CTC epoch parity: BatchNorm running statistics after "
          f"the step max_abs_err {serr:.3e}; launches {counts}", flush=True)

    fcfg = Config.from_dict(json.loads(cfg.to_json()))
    fcfg.audio.feat = "logfbank"
    batch = {k: torch.from_numpy(support[k][0]) for k in ("audio",
                                                          "audio_lengths")}
    card, cl = prepare_features({k: v.to(dev) for k, v in batch.items()},
                                fcfg)
    cpu, pl = prepare_features(batch, fcfg)
    check(torch.equal(cl.cpu(), pl), "log-fbank frame counts")
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-4, atol=1e-4)
    print(f"log-fbank parity: features {tuple(cpu.shape)} max_abs_err "
          f"{float((card.cpu() - cpu).abs().max()):.3e}", flush=True)

    ids = torch.Generator().manual_seed(SEED + 6)
    hyp = torch.randint(0, len(vocab), (24, 65), generator=ids)
    gold = torch.randint(0, len(vocab), (24, 65), generator=ids)
    space = vocab.label2id.get(" ")
    got = [int(v) for v in device_cer(hyp.to(dev), gold.to(dev), space)]
    want = [int(v) for v in device_cer(hyp, gold, space)]
    check(got == want, f"device CER card {got} cpu {want}")
    print(f"device CER parity: card {got} equals the CPU", flush=True)
    return counts


# -- the Conformer at BASELINE.json configs[4]'s width, second order, remat --

# bench.py:run_stretch_bench's configs[4] without its sharding: a 17-layer
# Conformer at d_model 1024 (8 heads; the decoder's d_k = d_v = 128,
# d_inner 2048, d_emb 1024), vgg_cnn, 4 decoder layers, bf16
CONFORMER_FLAGS = [
    "--feat_extractor", "vgg_cnn", "--encoder-type", "conformer",
    "--num-enc-layers", "17", "--num-dec-layers", "4", "--num-heads", "8",
    "--dim-model", "1024", "--dim-key", "128", "--dim-value", "128",
    "--dim-inner", "2048", "--dim-emb", "1024", "--r", "100", "--dtype",
    "bfloat16"]
CONFORMER_FO_STEPS, CONFORMER_SO_STEPS = 3, 4


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def conformer_serve(torch, dev, corpus_dir, models_dir):
    """Phase 24: a seeded checkpoint at configs[4]'s width served greedily
    by ``test_main`` on cuda over phase 6's 20 utterances in batches of 8,
    the counts zeroed before and read after: the FFT STFT and both bf16 VGG
    kernels once a batch, the direct STFT never. Returns the launch
    counts."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.config import build_parser, config_from_args
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    labels = os.path.join(corpus_dir, "labels.json")
    cfg = config_from_args(build_parser("").parse_args(
        CONFORMER_FLAGS + ["--labels-path", labels]))
    cfg.name, cfg.save_folder = "chip_conformer", models_dir
    vocab = Vocab.from_json(labels)
    model = build_model(cfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(SEED + 9))
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    ckpt = save_checkpoint(cfg, vocab, model.state_dict(), step=0,
                           best_model=True)
    del model
    print(f"Conformer checkpoint (configs[4] width): {n_params} params, "
          f"saved in {time.perf_counter() - t0:.1f} s", flush=True)
    res, out, wall, counts = _run_cli(
        torch, test_main, [
            "--test-manifest-list", os.path.join(corpus_dir,
                                                 "manifest_task0.csv"),
            "--labels-path", labels, "--continue-from", ckpt, "--device",
            dev.type, "--k-valid", "8", "--k-test", "8"],
        WORK, "chip_conformer_test")
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL CER")]
    preds = [ln for ln in out.splitlines() if ln.startswith("PRED:")]
    batches = math.ceil(UTTERANCES / 8)
    check(len(total) == 1 and len(preds) == UTTERANCES
          and res["utterances"] == UTTERANCES
          and all(math.isfinite(res[k]) for k in ("cer", "wer")),
          f"Conformer serving: {len(preds)} PRED lines, {total}")
    check(counts["stft_logmag"] == counts["vgg_block1"]
          == counts["vgg_block2"] == batches
          and counts["stft_logmag_direct"] == 0,
          f"Conformer serving must launch the FFT STFT and both bf16 VGG "
          f"kernels once a batch ({batches}): {counts}")
    print(f"{total[0]}\nConformer served {UTTERANCES} utterances greedily "
          f"in {wall:.3f} s: {UTTERANCES / wall:.3f} utterances/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"launches {counts}", flush=True)
    _free(torch)
    return counts


def _conformer_argv(dev, corpus, models, *extra):
    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    # no evaluation or checkpoint inside the run: the steps are the phase
    return (["--train-manifest-list", *manifests, "--valid-manifest-list",
             manifests[-1], "--labels-path", os.path.join(corpus,
                                                          "labels.json"),
             "--device", dev.type, "--k-train", str(K_SHOT), "--k-valid",
             str(K_SHOT), "--evaluate-every", "1000", "--save-every", "1000",
             "--dropout", "0.1", "--save-folder", models, "--src-buckets",
             "800"] + CONFORMER_FLAGS + list(extra))


def _time_meta_step(torch, dev, corpus, argv, name, what, note,
                    per_task_query=False):
    """One meta step of the flags ``argv`` on device-side batches, timed
    (median of 3 after a first) and profiled (the device alone)."""
    from mtl_tpu_torch.train.optim import make_meta_optimizers
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    cfg, vocab, ds, model = _train_corpus_setup(torch, dev, corpus, argv,
                                                name)
    batches = [[batch_to_device(b, dev) for b in ds.sample_meta_batch(
        K_SHOT, K_SHOT, per_task_query=per_task_query)] for _ in range(5)]
    _, opt = make_meta_optimizers(cfg)
    state = init_train_state(model, opt)
    step = make_meta_step(model, cfg, opt, per_task_query=per_task_query)
    gen = torch.Generator(dev).manual_seed(SEED)
    it = iter(batches)
    _time_and_profile(
        torch, what,
        lambda: float(step(state, *next(it, batches[-1]), gen)[1][
            "outer_loss"]), note, n=4, host=False)
    del state, step, model, batches
    _free(torch)


def conformer_train(torch, dev, work, corpus):
    """Phase 25: first-order meta-transfer at configs[4]'s width with
    ``--remat`` through ``meta_transfer_train_main`` on cuda, K 3 x (8 + 8)
    utterances of the phase-9 corpus, 3 steps; the counts zeroed before
    and read after: both bf16 VGG kernels and the stack's backward at least
    2K a step, the FFT STFT K + 1 a step. Then one step timed and
    profiled. Returns the launch counts and the run's peak memory (bytes,
    for phase 32)."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main

    argv = _conformer_argv(dev, corpus, os.path.join(work, "conf_models"),
                           "--remat")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    state, out, wall, counts = _run_cli(
        torch, meta_transfer_train_main,
        argv + ["--epochs", str(CONFORMER_FO_STEPS)], work,
        "chip_conformer_meta")
    peak = torch.cuda.max_memory_allocated()
    _finite_losses(out, CONFORMER_FO_STEPS, "Conformer meta run", False)
    check(state.step == CONFORMER_FO_STEPS, f"step {state.step}")
    del state
    _free(torch)
    _check_counts(counts, 2 * K_TASKS * CONFORMER_FO_STEPS,
                  "Conformer meta run (first order, --remat)",
                  forward=("vgg_block1", "vgg_block2", "vgg_stack_bwd"))
    check(counts["stft_logmag"] == (K_TASKS + 1) * CONFORMER_FO_STEPS,
          f"Conformer meta run STFT launches: {counts}")
    print(f"Conformer meta run: {CONFORMER_FO_STEPS} first-order meta steps "
          f"(K {K_TASKS}, {K_SHOT} + {K_SHOT}, bf16, --remat) in "
          f"{wall:.3f} s; TOTAL TIME per iteration after the first: median "
          f"{_per_iteration(out):.3f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _time_meta_step(torch, dev, corpus, argv, "chip_conformer_timing",
                    "Conformer meta step (first order, --remat)",
                    f"configs[4] width, bf16, K {K_TASKS}, {K_SHOT}+{K_SHOT}")
    return counts, peak


def conformer_second_order(torch, dev, work, corpus):
    """Phase 26: configs[4]'s training mode, ``--second-order --remat``
    meta-transfer at its width through ``meta_transfer_train_main``, K 3 x
    (8 + 8), 4 steps; the counts zeroed before and read after: the FFT
    STFT K + 1 a step, no VGG kernel and no ``vgg_stack_bwd`` (the plain
    route of second order). One step timed and profiled. Then one
    second-order MAML step through ``meta_train_main`` at the flagship
    width (its own query a task: the STFT 2K, no VGG kernel). Returns the
    meta-transfer run's launch counts."""
    from mtl_tpu_torch.cli.asr import meta_train_main, \
        meta_transfer_train_main

    argv = _conformer_argv(dev, corpus, os.path.join(work, "conf_models"),
                           "--remat", "--second-order")
    state, out, wall, counts = _run_cli(
        torch, meta_transfer_train_main,
        argv + ["--epochs", str(CONFORMER_SO_STEPS)], work,
        "chip_conformer_second_order")
    _finite_losses(out, CONFORMER_SO_STEPS, "second-order Conformer run",
                   False)
    check(state.step == CONFORMER_SO_STEPS, f"step {state.step}")
    del state
    _free(torch)
    vgg = [k for k in ("vgg_block1", "vgg_block2", "vgg_block1_f32",
                       "vgg_block2_f32", "vgg_stack_bwd") if counts[k]]
    check(counts["stft_logmag"] == (K_TASKS + 1) * CONFORMER_SO_STEPS
          and not vgg and counts["stft_logmag_direct"] == 0,
          f"the second-order run must launch the FFT STFT K + 1 a step and "
          f"no VGG kernel nor the stack's backward: {counts}")
    print(f"second-order Conformer run: {CONFORMER_SO_STEPS} meta steps "
          f"(K {K_TASKS}, {K_SHOT} + {K_SHOT}, bf16, --second-order --remat)"
          f" in {wall:.3f} s; TOTAL TIME per iteration after the first: "
          f"median {_per_iteration(out):.3f} ms; launches {counts}",
          flush=True)
    _time_meta_step(torch, dev, corpus, argv, "chip_conformer_so_timing",
                    "second-order Conformer meta step (--remat)",
                    f"configs[4] width, bf16, K {K_TASKS}, {K_SHOT}+{K_SHOT}")

    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    maml_argv = _asr_train_argv(dev, manifests, os.path.join(
        corpus, "labels.json"), os.path.join(work, "maml_so_models")) + [
        "--second-order", "--epochs", "1", "--evaluate-every", "1000",
        "--save-every", "1000"]
    state, out, wall, mcounts = _run_cli(torch, meta_train_main, maml_argv,
                                         work, "chip_maml_second_order")
    _finite_losses(out, 1, "second-order MAML run", False)
    vgg = [k for k in ("vgg_block1", "vgg_block2", "vgg_block1_f32",
                       "vgg_block2_f32", "vgg_stack_bwd") if mcounts[k]]
    check(state.step == 1 and "Meta Trainer is initialized" in out
          and mcounts["stft_logmag"] == 2 * K_TASKS and not vgg,
          f"second-order MAML: step {state.step}, launches {mcounts}")
    print(f"second-order MAML step (flagship width, K {K_TASKS}, {K_SHOT} + "
          f"{K_SHOT} own query) through meta_train_main in {wall:.3f} s; "
          f"launches {mcounts}", flush=True)
    del state
    _free(torch)
    return counts


def conformer_parity(torch, dev, corpus):
    """Phase 27, f32 on the card against the CPU and remat on the card:
    (a) one second-order meta step at the flagship Transformer width,
    dropout 0, ``--clip``, as phase 10 (loss, outer gradients, the params
    after Adam) with no VGG kernel launched; (b) the Conformer encoder at
    configs[4]'s width on 2 rows of 100 frames (one padded to 70): rtol /
    atol 1e-3 (f32, TF32 off, summation order only over 17 blocks); (c)
    at configs[4]'s width, bf16, dropout 0.1, one task batch's loss and
    gradients with ``--remat --remat-conv`` against without, one CUDA
    generator seed: equal loss and generator state, gradients within 2^-8
    of the largest (one bf16 ulp of it: cuBLAS may pick another bf16 GEMM
    algorithm for the recompute's buffers; a mask drawn anew in the
    recompute moves them by far more)."""
    from mtl_tpu_torch.config import build_parser, config_from_args
    from mtl_tpu_torch.models.conformer import ConformerEncoder
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_forward_fn, make_meta_step)

    cfg, vocab, support, query, weights, _ = _parity_inputs(torch, corpus)
    cfg.train.second_order, cfg.train.clip = True, True
    lr = cfg.train.meta_lr

    def run(model, opt, d):
        state = init_train_state(model, opt)
        _, m = make_meta_step(model, cfg, opt)(
            state, batch_to_device(support, d), batch_to_device(query, d))
        return m["outer_loss"]

    counts = _step_parity(torch, dev, cfg, vocab, weights, run,
                          (("adam", lr, lambda: Adam(lr)),),
                          "second-order train")
    vgg = [k for k in ("vgg_block1", "vgg_block2", "vgg_block1_f32",
                       "vgg_block2_f32", "vgg_stack_bwd") if counts[k]]
    check(counts["stft_logmag"] >= 1 and not vgg,
          f"the f32 second-order step must run the STFT and no VGG kernel: "
          f"{counts}")
    print(f"launches in the f32 second-order parity run: {counts}",
          flush=True)

    enc = ConformerEncoder(17, 8, 1024, 5120, dropout=0.0,
                           dtype=torch.float32)
    init_weights(enc, torch.Generator().manual_seed(SEED + 10))
    rng = np.random.RandomState(SEED + 10)
    x = torch.from_numpy(rng.randn(2, 100, 5120).astype(np.float32))
    lengths = torch.tensor([100, 70])
    with torch.no_grad():
        want = enc(x, lengths)
        got = enc.to(dev)(x.to(dev), lengths.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    check(bool((got[1, 70:] == 0).all()), "padded Conformer frames")
    print(f"Conformer encoder parity (f32, 17 blocks, d 1024, 2 x 100 "
          f"frames): max_abs_err {float((got - want).abs().max()):.3e} of "
          f"max {float(want.abs().max()):.3e}", flush=True)
    del enc, x, got, want
    _free(torch)

    rcfg = config_from_args(build_parser("").parse_args(
        CONFORMER_FLAGS + ["--dropout", "0.1", "--labels-path",
                           os.path.join(corpus, "labels.json")]))
    batch = {k: torch.from_numpy(v[0]).to(dev) for k, v in support.items()}
    runs = []
    for on in (False, True):
        rcfg.model.remat = rcfg.model.remat_conv = on
        model = build_model(rcfg, len(vocab), dev)
        init_weights(model, torch.Generator().manual_seed(SEED + 11))
        gen = torch.Generator(dev).manual_seed(SEED + 11)
        native.reset_launch_counts()
        loss, _ = make_forward_fn(model, rcfg)(None, batch, gen, False)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        runs.append((loss.detach(), [g.float() for g in grads],
                     gen.get_state(), dict(native.launch_counts)))
        del model, loss, grads
        _free(torch)
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs
    scale = max(float(g.abs().max()) for g in g0)
    gerr = max(float((a - b).abs().max()) for a, b in zip(g1, g0))
    check(torch.equal(l0, l1) and torch.equal(s0, s1)
          and gerr <= 2.0 ** -8 * scale,
          f"--remat on vs off: loss {float(l0)} / {float(l1)}, generator "
          f"equal {torch.equal(s0, s1)}, gradients differ by {gerr}")
    check(c1["vgg_block1"] == 2 * c0["vgg_block1"] == 2,
          f"--remat-conv reruns the VGG kernels in the recompute: {c0} "
          f"{c1}")
    print(f"remat parity (configs[4] width, bf16, dropout 0.1, 2 "
          f"utterances of 400 frames): loss {float(l0):.6f} equal, "
          f"generator state equal, gradients max_abs_err {gerr:.3e} of max "
          f"{scale:.3e}; launches off {c0} on {c1}", flush=True)
    return counts


LM_WORDS, LM_TOKENS = (12000, 8000), 100_000


def write_lm_corpora(root, seed):
    """Three word corpora of LM_TOKENS training tokens each (train, valid,
    test of 10 % each): an English-like task over 12,000 words, a Chinese
    task over 8,000 characters and a code-switched task over both, so the
    chained dictionary holds ~20,000 words. Half of each task's tokens
    follow a Zipf law over its words, half are uniform; valid and test use
    only words of their task's train text. Returns the task dirs."""
    rng = np.random.RandomState(seed)
    en = [f"w{i}" for i in range(LM_WORDS[0])]
    zh = [chr(0x4E00 + i) for i in range(LM_WORDS[1])]
    dirs = []
    for k, pool in enumerate((en, zh, en + zh)):
        order = rng.permutation(len(pool))

        def draw(n, words):
            zipf = np.minimum(rng.zipf(1.3, n) - 1, len(words) - 1)
            ids = np.where(rng.rand(n) < 0.5, zipf,
                           rng.randint(0, len(words), n))
            return [words[i] for i in ids]

        def write(path, tokens):
            lines, i = [], 0
            while i < len(tokens):
                n = rng.randint(8, 26)
                lines.append(" ".join(tokens[i:i + n]))
                i += n
            with open(path, "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")

        d = os.path.join(root, f"lm_task{k}")
        os.makedirs(d, exist_ok=True)
        train = draw(LM_TOKENS, [pool[i] for i in order])
        write(os.path.join(d, "train.txt"), train)
        seen = sorted(set(train))
        for split in ("valid", "test"):
            write(os.path.join(d, f"{split}.txt"),
                  draw(LM_TOKENS // 10, seen))
        dirs.append(d)
    return dirs


def _lm_lists(tasks):
    out = []
    for split in ("train", "valid", "test"):
        out += [f"--{split}-path-list"] + [os.path.join(t, f"{split}.txt")
                                           for t in tasks]
    return out


def lm_train(torch, dev, work):
    """Phase 13: the four LM training mains on cuda at lm_parser's
    defaults (LSTM, emsize 200, nhid 200, 2 layers, batch 20, bptt 35,
    dropout 0.2, lr 20, clip 0.25) over three written corpora: plain
    epochs on the code-switched task, joint and first-order meta-transfer
    over the three, meta-transfer with --second-order for a few
    iterations, a finetune of the meta checkpoint, and the LM's test_main
    on the finetuned LM. Returns the task dirs."""
    from mtl_tpu_torch.cli import lm as cli

    root = os.path.join(work, "lm_train")
    tasks = write_lm_corpora(os.path.join(root, "corpus"), SEED + 3)
    target = [a for split in ("train", "valid", "test")
              for a in (f"--{split}_path",
                        os.path.join(tasks[-1], f"{split}.txt"))]
    base = ["--device", dev.type, "--save", os.path.join(root, "models")]
    iters = ["--num-iterations", "40", "--log-interval", "10",
             "--valid-interval", "20"]
    runs = [
        ("plain", cli.main_main, base + target + ["--epochs", "2",
                                                  "--name", "plain"]),
        ("joint", cli.main_joint_main,
         base + _lm_lists(tasks) + iters + ["--name", "joint"]),
        ("meta", cli.main_meta_transfer_main,
         base + _lm_lists(tasks) + iters + ["--name", "meta"]),
        ("meta_second_order", cli.main_meta_transfer_main,
         base + _lm_lists(tasks) + [
             "--num-iterations", "6", "--log-interval", "3",
             "--valid-interval", "6", "--second-order", "--name", "so"]),
    ]
    saved = {}

    def drive(name, main, argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.chdir(work), contextlib.redirect_stdout(buf):
            res = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        with open(os.path.join(root, f"{name}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(out)
        shown = [ln for ln in out.splitlines() if "loss" in ln
                 or ln.startswith("SAVED")]
        nums = [float(x) for ln in shown
                for x in re.findall(r"loss\"?:?\s+([^\s,|]+)", ln)]
        check(nums and all(map(math.isfinite, nums)),
              f"LM {name}: {out[-800:]}")
        for ln in shown:
            print(f"lm {name}: {ln[:160]}", flush=True)
        print(f"lm {name}: {wall:.3f} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB",
              flush=True)
        return res

    for name, main, argv in runs:
        saved[name] = os.path.join(work, drive(name, main, argv))
        for f in ("meta.json", "model.pt"):
            check(os.path.exists(os.path.join(saved[name], f)),
                  f"LM {name} saved no {f}")
    ft = drive("finetune", cli.finetune_main, base + [
        "--load", saved["meta"], "--epochs", "1", "--name", "finetune"]
        + target[:4])
    res = drive("test", cli.test_main, [
        "--device", dev.type, "--load", os.path.join(work, ft),
        "--test_path", os.path.join(tasks[-1], "test.txt"),
        "--name", "chip_smoke_finetuned"])
    check(math.isfinite(res["ppl"]), f"LM test_main {res}")
    return tasks


def _lm_setup(torch, tasks):
    """(chained corpora, dictionary size, LMDataset at bptt 35, batch 20)."""
    from mtl_tpu_torch.lm.data import Corpus, LMDataset

    corpora, dictionary = [], None
    for t in tasks:
        c = Corpus(*(os.path.join(t, f"{s}.txt")
                     for s in ("train", "valid", "test")), dictionary)
        dictionary = c.dictionary
        corpora.append(c)
    return corpora, len(dictionary), LMDataset([c.train for c in corpora],
                                               35, 20)


# the LM steps measured, by the model's route (cell loop or cuDNN)
LM_KINDS = {False: ("plain window", "joint iteration",
                    "meta iteration (first order)"),
            True: ("meta iteration (second order)",)}


def _lm_steps(torch, model, ds, lr, gen):
    """{kind: callable running one step of that kind on ``model``} over
    the dataset's windows, at lm_parser's clip, ratio and meta_lr_factor
    (second order needs a cell-loop model)."""
    from mtl_tpu_torch.lm.data import batchify, get_batch
    from mtl_tpu_torch.lm.train import (joint_ratios, make_lm_joint_step,
                                        make_lm_meta_step, make_lm_sgd_step)

    ratios = joint_ratios(3, 0.8)
    source = ds.task_list[-1]
    it = [0]
    carry = [model.init_carry(source.shape[1])]

    def windows():
        i = it[0] % 50
        it[0] += 1
        samples = [ds.sample(k, i) for k in range(3)]
        return (np.stack([s[0] for s in samples]),
                np.stack([s[1] for s in samples]), *ds.sample(-1, i)[2:])

    if model.cell_loop:
        meta = make_lm_meta_step(model, 0.25, ratios, 3.0, second_order=True)
        return {LM_KINDS[True][0]: lambda: meta(*windows(), lr, gen)[0]}
    sgd = make_lm_sgd_step(model, 0.25)
    jnt = make_lm_joint_step(model, 0.25, ratios)
    meta = make_lm_meta_step(model, 0.25, ratios, 3.0)

    def plain():
        i = it[0] % ((len(source) - 1) // 35) * 35
        it[0] += 1
        loss, carry[0] = sgd(*get_batch(source, i, 35), lr, gen, carry[0])
        return loss

    def joint_step():
        d, t, _, _ = windows()
        return jnt(d, t, lr, gen)[0]

    return dict(zip(LM_KINDS[False], (
        plain, joint_step, lambda: meta(*windows(), lr, gen)[0])))


def lm_timing(torch, dev, tasks):
    """Phase 14: ms per LM step of each kind at lm_parser's defaults
    (dropout 0.2 from a seeded generator), median of 10 after 2 warm-up
    steps, each ended by a synchronize; peak memory; one profiled step's
    busy share."""
    from mtl_tpu_torch.lm.model import RNNLM, init_lm_weights

    _, ntok, ds = _lm_setup(torch, tasks)
    for cell_loop in (False, True):
        model = RNNLM("LSTM", ntok, 200, 200, 2, 0.2, False,
                      cell_loop=cell_loop)
        init_lm_weights(model, torch.Generator().manual_seed(SEED))
        model.to(dev)
        gen = torch.Generator(dev).manual_seed(SEED)
        for kind, fn in _lm_steps(torch, model, ds, 20.0, gen).items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _time_steps(torch, lambda: float(fn()), 12)[2:]
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            wall_ms, busy, by_name, _ = _profile_once(
                torch, lambda: float(fn()))
            top = sorted(by_name.items(), key=lambda x: -x[1])[:3]
            print(f"LM {kind} (LSTM 200/200 x 2, {ntok} words, batch 20, "
                  f"bptt 35, dropout 0.2): median {sorted(ms)[5]:.3f} ms "
                  f"(min {min(ms):.3f}, max {max(ms):.3f}); peak memory "
                  f"{peak:.1f} MiB; profiled: wall {wall_ms:.3f} ms, "
                  f"device busy {busy:.3f} ms, busy share "
                  f"{busy / wall_ms:.4f}; top device ops "
                  + "; ".join(f"{n[:50]} {t:.3f}" for n, t in top),
                  flush=True)


def lm_parity(torch, dev, tasks):
    """Phase 15: one step of each kind at f32 with dropout 0 on the card,
    TF32 allowed globally (the steps hold themselves to f32, backward
    included), against the CPU from the same weights and windows: loss
    within 1e-5 relative, params after the SGD update within 1e-5 * lr."""
    from mtl_tpu_torch.lm.model import RNNLM, init_lm_weights

    _, ntok, ds = _lm_setup(torch, tasks)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for cell_loop in (False, True):
            res = []
            for d in (dev, torch.device("cpu")):
                out = {}
                for kind in LM_KINDS[cell_loop]:
                    model = RNNLM("LSTM", ntok, 200, 200, 2, 0.0, False,
                                  cell_loop=cell_loop)
                    init_lm_weights(model, torch.Generator().manual_seed(
                        SEED + 1))
                    model.to(d)
                    loss = float(_lm_steps(torch, model, ds, 20.0,
                                           None)[kind]())
                    out[kind] = (loss, {k: v.detach().cpu() for k, v in
                                        model.state_dict().items()})
                res.append(out)
            for kind, (loss, params) in res[1].items():
                card_loss, card_params = res[0][kind]
                err = max(float((card_params[k] - v).abs().max())
                          for k, v in params.items())
                print(f"lm parity {kind} (f32, card with TF32 allowed vs "
                      f"cpu): loss card {card_loss:.7f} cpu {loss:.7f}; "
                      f"params after the step max_abs_err {err:.3e}",
                      flush=True)
                check(math.isclose(card_loss, loss, rel_tol=1e-5),
                      f"LM {kind} loss card {card_loss} cpu {loss}")
                check(err <= 1e-5 * 20.0, f"LM {kind} params differ by {err}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# -- the mesh: task/data-parallel training, sequence-parallel serving ------

MESH_STEPS, SP_UTTERANCES, SP_FRAMES = 3, 4, 6400
TP_CONFORMER_STEPS = 2
SP_COUNTS = ("vgg_block1", "vgg_block2", "vgg_block1_f32", "vgg_block2_f32")


def _mesh_train_argv(dev, corpus):
    """Phase 28's flags: the flagship width, K 3 x (8 + 8), dropout 0 (so
    that the mesh draws no other masks than one process), no evaluation or
    checkpoint inside the run."""
    manifests = [os.path.join(corpus, f"manifest_task{i}.csv")
                 for i in range(K_TASKS)]
    return (["--train-manifest-list", *manifests, "--valid-manifest-list",
             manifests[-1], "--labels-path", os.path.join(corpus,
                                                          "labels.json"),
             "--device", dev.type, "--k-train", str(K_SHOT), "--k-valid",
             str(K_SHOT), "--evaluate-every", "1000", "--save-every", "1000",
             "--dropout", "0", "--save-folder", os.path.join(WORK,
                                                             "mesh_models"),
             "--src-buckets", "800", "--epochs", str(MESH_STEPS)]
            + TRAIN_FLAGS)


def _rank_lines(stats, keys):
    return "; ".join(
        f"rank {r}: " + ", ".join(f"{k} {s[k]}" for k in keys)
        + f", peak {s['peak_bytes'] / 2**20:.1f} MiB"
        for r, s in enumerate(stats))


def mesh_train(torch, dev, corpus):
    """Phase 28: ``meta_transfer_train_main --mesh-task 3`` on the card (3
    ranks, each one task of 8 + 8 utterances; on one card they share it
    over gloo, with a card each NCCL connects them), bf16,
    dropout 0, 3 steps, beside the same argv in one process: every loss
    finite and within 1e-3 relative of the single process's; the FFT STFT,
    both bf16 VGG kernels and the stack's backward launched on every rank
    (each rank's counts gathered by the launcher); step ms beside the
    single process's and the peak memory of each rank. Returns (the argv,
    the single process's output, its peak MiB, its state's bytes) for
    phase 31."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.parallel import launch

    argv = _mesh_train_argv(dev, corpus)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    single_state, single, _, _ = _run_cli(torch, meta_transfer_train_main,
                                          argv, WORK, "chip_mesh_single")
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    _, sharded, wall, _ = _run_cli(
        torch, meta_transfer_train_main, argv + ["--mesh-task",
                                                 str(K_TASKS)],
        WORK, "chip_mesh_task3")
    mesh_line = [ln for ln in sharded.splitlines() if ln.startswith("MESH")]
    check(len(mesh_line) == 1 and "task=3 data=1 model=1" in mesh_line[0],
          f"mesh line {mesh_line}")
    print(mesh_line[0], flush=True)
    want = _finite_losses(single, MESH_STEPS, "single-process run", False)
    got = _finite_losses(sharded, MESH_STEPS, "mesh run", False)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    print(f"mesh train: TRAIN LOSS task-3 mesh {got} vs one process {want}: "
          f"max relative difference {rel:.3e} (bound 1e-3; the printed "
          f"4 decimals)", flush=True)
    check(rel <= 1e-3, f"mesh losses {got} vs single {want}")
    stats = list(launch.rank_stats)
    check(len(stats) == K_TASKS, f"rank stats {stats}")
    need = 2 * MESH_STEPS  # a task's support and query forwards a step
    for r, s in enumerate(stats):
        check(all(s[k] >= need for k in ("vgg_block1", "vgg_block2",
                                         "vgg_stack_bwd", "stft_logmag"))
              and s["stft_logmag_direct"] == 0
              and s["vgg_block1_f32"] == s["vgg_block2_f32"] == 0,
              f"rank {r} must launch the FFT STFT, both bf16 VGG kernels and "
              f"the backward >= {need} times: {s}")
    print("launches and peak memory by rank in the mesh train run: "
          + _rank_lines(stats, ("stft_logmag", "vgg_block1", "vgg_block2",
                                "vgg_stack_bwd")), flush=True)
    print(f"mesh train: TOTAL TIME per iteration after the first (host "
          f"clock): task-3 mesh over {K_TASKS} ranks on "
          f"{min(K_TASKS, torch.cuda.device_count())} card(s) "
          f"{_per_iteration(sharded):.3f} ms vs one process "
          f"{_per_iteration(single):.3f} ms; peak memory one process "
          f"{single_peak:.1f} MiB; mesh run {wall:.1f} s wall with the "
          f"ranks' start", flush=True)
    return argv, single, single_peak, _state_bytes(single_state)


def _state_bytes(state):
    """Bytes of a ``TrainState``'s parameters and optimizer moments."""
    tensors = list(state.params.values())
    for value in state.opt_state.tensors().values():
        if isinstance(value, dict):
            tensors += list(value.values())
    return sum(t.numel() * t.element_size() for t in tensors)


def _tp_rank_check(stats, steps, what):
    """Every rank of a tensor-parallel meta run of ``steps`` steps launched
    the replicated front-end's kernels as one process does: both bf16 VGG
    kernels and the stack's backward 2K times a step, the FFT STFT K + 1
    (the shared query's features once), the direct STFT and the f32 VGG
    kernels never."""
    need = {"vgg_block1": 2 * K_TASKS * steps, "vgg_block2": 2 * K_TASKS
            * steps, "vgg_stack_bwd": 2 * K_TASKS * steps,
            "stft_logmag": (K_TASKS + 1) * steps}
    for r, st in enumerate(stats):
        check(all(st[k] >= n for k, n in need.items())
              and st["stft_logmag_direct"] == 0
              and st["vgg_block1_f32"] == st["vgg_block2_f32"] == 0,
              f"{what}: rank {r} must launch at least {need}, the direct "
              f"STFT and the f32 VGG kernels never: {st}")
    print(f"launches and peak memory by rank in the {what}: "
          + _rank_lines(stats, ("stft_logmag", "vgg_block1", "vgg_block2",
                                "vgg_stack_bwd")), flush=True)


def tp_train(torch, dev, argv, single, single_peak, single_bytes):
    """Phase 31: ``meta_transfer_train_main --mesh-model 2`` at the
    flagship width (2 ranks sharing the card over gloo, tensor parallel:
    each holds its slice of the split weights and their Adam moments), phase
    28's argv (bf16, dropout 0, 3 steps, K 3 x (8 + 8)), beside phase 28's
    one-process run of it: every loss finite and within 1e-3 relative of
    the one process's; every rank launched the FFT STFT, both bf16 VGG
    kernels and the stack's backward (the launcher's counts); step ms
    beside the one process's; each rank's peak memory; rank 0's bytes of
    params and moments beside the one process's (the ranks hold equal
    slices)."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.parallel import launch

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    state, out, wall, _ = _run_cli(
        torch, meta_transfer_train_main, argv + ["--mesh-model", "2"], WORK,
        "chip_tp_model2")
    mesh_line = [ln for ln in out.splitlines() if ln.startswith("MESH")]
    check(len(mesh_line) == 1 and "task=1 data=1 model=2" in mesh_line[0],
          f"TP mesh line {mesh_line}")
    want = _finite_losses(single, MESH_STEPS, "single-process run", False)
    got = _finite_losses(out, MESH_STEPS, "TP run", False)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    print(f"TP train: TRAIN LOSS model-2 mesh {got} vs one process {want}: "
          f"max relative difference {rel:.3e} (bound 1e-3; the printed 4 "
          f"decimals)", flush=True)
    check(rel <= 1e-3, f"TP losses {got} vs single {want}")
    stats = list(launch.rank_stats)
    check(len(stats) == 2, f"rank stats {stats}")
    _tp_rank_check(stats, MESH_STEPS, "TP train run")
    mine = _state_bytes(state)
    print(f"TP train: TOTAL TIME per iteration after the first (host "
          f"clock): model-2 mesh over 2 ranks on one card "
          f"{_per_iteration(out):.3f} ms vs one process "
          f"{_per_iteration(single):.3f} ms; params + Adam moments rank 0 "
          f"{mine / 2**20:.1f} MiB vs one process {single_bytes / 2**20:.1f}"
          f" MiB ({mine / single_bytes:.3f}); peak memory "
          f"one process {single_peak:.1f} MiB; run {wall:.1f} s wall with "
          f"the ranks' start", flush=True)
    check(mine < single_bytes, "TP rank 0 holds less than one process")
    del state
    _free(torch)


def tp_conformer(torch, dev, work, corpus, single_peak):
    """Phase 32: tensor-parallel training at configs[4]'s width,
    ``meta_transfer_train_main --mesh-model 2 --remat`` (2 ranks sharing
    the card over gloo; phase 25's flags: bf16, dropout 0.1, K 3 x (8 +
    8)), 2 steps: every loss finite; every rank launched the FFT STFT, both
    bf16 VGG kernels and the stack's backward; step ms; each rank's peak
    memory beside phase 25's one-process peak."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.parallel import launch

    argv = _conformer_argv(dev, corpus, os.path.join(work, "conf_models"),
                           "--remat", "--mesh-model", "2")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    state, out, wall, _ = _run_cli(
        torch, meta_transfer_train_main,
        argv + ["--epochs", str(TP_CONFORMER_STEPS)], work,
        "chip_tp_conformer")
    _finite_losses(out, TP_CONFORMER_STEPS, "TP Conformer run", False)
    check(state.step == TP_CONFORMER_STEPS, f"step {state.step}")
    stats = list(launch.rank_stats)
    check(len(stats) == 2, f"rank stats {stats}")
    _tp_rank_check(stats, TP_CONFORMER_STEPS, "TP Conformer run")
    peaks = [st["peak_bytes"] / 2**30 for st in stats]
    print(f"TP Conformer run: {TP_CONFORMER_STEPS} first-order meta steps "
          f"(configs[4] width, --remat, model 2 over 2 ranks on one card) "
          f"in {wall:.3f} s; TOTAL TIME per iteration after the first "
          f"{_per_iteration(out):.3f} ms; params + Adam moments rank 0 "
          f"{_state_bytes(state) / 2**30:.3f} GiB; peak memory by rank "
          f"{[round(p, 2) for p in peaks]} GiB vs one process (phase 25) "
          f"{single_peak / 2**30:.2f} GiB", flush=True)
    del state
    _free(torch)


# (cell, mesh flags): --tp-scaling's runs, in order
TP_SCALING = (("flagship", []), ("flagship", ["--mesh-model", "2"]),
              ("flagship", ["--mesh-model", "4"]), ("conformer", []),
              ("conformer", ["--mesh-model", "4"]),
              ("conformer", ["--mesh-model", "2"]),
              ("conformer", ["--mesh-task", "3"]),
              ("conformer", ["--mesh-data", "2"]))


def tp_scaling(torch, dev, corpus):
    """``--tp-scaling`` (four cards, not part of the smoke run): first-order
    meta steps, one process beside ``--mesh-model`` 2 and 4 over NCCL with
    a card per rank, at the flagship width (phase 28's argv, 4 steps) and
    at configs[4]'s (phase 25's flags with ``--remat``, dropout 0, 3
    steps), and at configs[4]'s on a task-3 mesh (each task's gradient
    computed as in one process, the sum over the tasks in another order)
    and on a data-2 mesh (each rank half of every batch, so every product
    and gradient rounded otherwise, without a split weight): each run's
    losses, ms per iteration after the first (host clock), rank 0's params
    + moments and each rank's peak memory."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.parallel import launch

    check(torch.cuda.device_count() >= 4,
          f"--tp-scaling needs 4 cards, found {torch.cuda.device_count()}")
    flagship = _mesh_train_argv(dev, corpus)
    conformer = _conformer_argv(dev, corpus, os.path.join(WORK,
                                                          "conf_models"),
                                "--remat", "--dropout", "0")
    for cell, flags in TP_SCALING:
        steps = 4 if cell == "flagship" else 3
        argv = (flagship if cell == "flagship" else conformer) + flags
        name = (f"{cell}_" + (f"{flags[0][7:]}{flags[1]}_nccl" if flags
                              else "one_process"))
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        launch.rank_stats[:] = []
        state, out, wall, _ = _run_cli(
            torch, meta_transfer_train_main, argv + ["--epochs", str(steps)],
            WORK, name)
        losses = _finite_losses(out, steps, name, False)
        peaks = ([s["peak_bytes"] / 2**30 for s in launch.rank_stats]
                 or [torch.cuda.max_memory_allocated() / 2**30])
        mesh = [ln for ln in out.splitlines() if ln.startswith("MESH")]
        print(f"{name}: {mesh} losses {losses}; per iteration after the "
              f"first {_per_iteration(out):.3f} ms; params + moments rank 0 "
              f"{_state_bytes(state) / 2**30:.4f} GiB; peak GiB by rank "
              f"{[round(p, 3) for p in peaks]}; wall {wall:.1f} s",
              flush=True)
        del state


def _sp_corpus(work):
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus

    manifests, labels = make_synthetic_corpus(
        os.path.join(work, "sp_corpus"), num_tasks=1,
        utts_per_task=SP_UTTERANCES, min_sec=40.0, max_sec=60.0,
        seed=SEED + 5)
    return manifests[0], labels


def sp_serve(torch, dev, ckpt, manifest, labels):
    """Phase 30: ``test_main --mesh-model 2`` (2 ranks sharing the card over
    gloo) over 4 synthetic utterances of 40-60 s in batches of 2, bucket
    6400 frames (1600 encoder frames), ``--src-max-len 4000``; beside it
    the unsharded ``test_main`` of the same batches. PRED lines and finite
    totals; each rank launched the FFT STFT and both bf16 VGG kernels once
    a batch (its haloed slice); utterances/s and each rank's peak
    memory."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.parallel import launch

    argv = ["--test-manifest-list", manifest, "--labels-path", labels,
            "--continue-from", ckpt, "--device", dev.type, "--k-test", "2",
            "--src-buckets", str(SP_FRAMES), "--src-max-len", "4000"]
    batches = SP_UTTERANCES // 2
    res = {}
    for name, extra in (("chip_sp_plain", []),
                        ("chip_sp_model2", ["--mesh-model", "2"])):
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        res[name] = _run_cli(torch, test_main, argv + extra, WORK, name)
        result, out = res[name][:2]
        preds = [ln for ln in out.splitlines() if ln.startswith("PRED:")]
        check(len(preds) == SP_UTTERANCES
              and result["utterances"] == SP_UTTERANCES
              and all(math.isfinite(result[k]) for k in ("cer", "wer")),
              f"{name}: {len(preds)} PRED lines, {result}")
        res[name] += (torch.cuda.max_memory_allocated() / 2 ** 20,)
    out = res["chip_sp_model2"][1]
    check("sequence-parallel encode: time axis over model=2 "
          "(src_max_len=4000)" in out, "the SP log line")
    stats = list(launch.rank_stats)
    for r, s in enumerate(stats):
        check(s["stft_logmag"] == s["vgg_block1"] == s["vgg_block2"]
              == batches and s["stft_logmag_direct"] == 0,
              f"SP rank {r} must launch the FFT STFT and both bf16 VGG "
              f"kernels once a batch ({batches}): {s}")
    print("launches and peak memory by rank in the SP run: "
          + _rank_lines(stats, ("stft_logmag", "vgg_block1", "vgg_block2")),
          flush=True)
    for name in ("chip_sp_plain", "chip_sp_model2"):
        wall, peak = res[name][2], res[name][4]
        print(f"{name}: {SP_UTTERANCES} utterances of 40-60 s in "
              f"{wall:.3f} s: {SP_UTTERANCES / wall:.3f} utterances/s "
              f"(ranks' start included for the mesh); rank 0 peak "
              f"{peak:.1f} MiB", flush=True)


def _sp_batch(torch, ckpt, manifest, dtype):
    """One batch of 2 long utterances: (config at ``dtype``, vocab, state
    dict, audio batch)."""
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, vocab, state_dict, _, _ = load_checkpoint(ckpt)
    cfg.model.src_max_len, cfg.model.dtype = 4000, dtype
    cfg.data.src_bucket_frames = (SP_FRAMES,)
    ds = SpectrogramDataset(vocab, cfg, [manifest], normalize=True)
    batch, _ = next(ds.iter_batches(2, shuffle=False, with_valid_count=True))
    return cfg, vocab, state_dict, {k: batch[k] for k in ("audio",
                                                          "audio_lengths")}


def _mesh_check_rank(mesh, spec):
    """Phase 29 on every rank of a 2-rank group sharing the card: the f32
    sharded meta steps (first and second order) and the emb_cnn epoch step
    on (task 1, data 2), and the SP encodes on (data 1, model 2); rank 0
    computes each unsharded counterpart on the card after the sharded run
    and returns both."""
    import torch

    from mtl_tpu_torch.cli.common import load_asr_model
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.models.subsampler import subsampled_length
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from mtl_tpu_torch.parallel.sp import (encode_sp, gather_encoder_output,
                                           time_slices)
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step, make_meta_step,
                                           prepare_features)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {}
    dp = make_mesh((1, 2, 1), dev)
    tpm = make_mesh((1, 1, 2), dev)
    for name, cfg_json, weights, sup, qry, kind in spec["tp_steps"]:
        out[name] = _tp_check(torch, tpm, dev, Config.from_dict(
            json.loads(cfg_json)), len(spec["vocab"]), weights, sup, qry,
                              kind)
    for name, cfg_json, weights, sup, qry in spec["steps"]:
        cfg = Config.from_dict(json.loads(cfg_json))
        results = []
        for on_mesh in (True, False):
            if not (on_mesh or dp.is_root):
                continue
            model = build_model(cfg, len(spec["vocab"]), dev)
            model.load_state_dict(weights)
            rec = _Recorder()
            state = init_train_state(model, rec)
            m = dp if on_mesh else None
            shard = ((lambda b, t: shard_batch(b, dp, t)) if on_mesh
                     else (lambda b, t: b))
            if qry is None:  # the epoch step: K 1 over data
                _, loss, _ = make_joint_step(model, cfg, rec, mesh=m)(
                    state, batch_to_device(shard(sup, True), dev))
            else:
                _, met = make_meta_step(model, cfg, rec, mesh=m)(
                    state, batch_to_device(shard(sup, True), dev),
                    batch_to_device(shard(qry, False), dev))
                loss = met["outer_loss"]
            results.append((float(loss), rec.grads, {
                k: v.detach().float().cpu()
                for k, v in model.named_buffers()}))
            del model, state
        if dp.is_root:
            out[name] = results
    sp = make_mesh((1, 1, 2), dev)
    for name, ckpt_cfg, weights, batch in spec["encodes"]:
        cfg = Config.from_dict(json.loads(ckpt_cfg))
        model = load_asr_model(cfg, spec["vocab"], weights, dev)
        b = batch_to_device(batch, dev)
        torch.cuda.synchronize(dev)
        native.reset_launch_counts()
        feats, lengths = prepare_features(b, cfg)
        slices = time_slices(subsampled_length(model.conv.feat_extractor,
                                               feats.shape[1]), 2)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            enc = encode_sp(model, feats, lengths, sp.model, slices)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - held
        counts = dict(native.launch_counts)
        full = gather_encoder_output(enc, slices, sp)
        every = comm_all(torch, [counts[k] for k in SP_COUNTS] + [peak], sp)
        if sp.is_root:
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            with torch.no_grad():
                want = model.encode(feats, lengths)
            torch.cuda.synchronize(dev)
            out[name] = (full.float().cpu(), want.float().cpu(), every,
                         torch.cuda.max_memory_allocated(dev) - held,
                         slices)
        del model
    return out if mesh.is_root else None


def _tp_check(torch, tpm, dev, cfg, vocab_size, weights, sup, qry, kind):
    """Phase 29's tensor-parallel steps (on every rank of the 2-rank
    group): one step of ``kind`` ("meta", "joint" or "epoch") on the
    (task 1, data 1, model 2) mesh ``tpm``, its gradients gathered to full,
    and whether the replicated leaves are bitwise equal on both ranks after
    the update; rank 0 then runs the same step in one process. Returns
    [(loss, gradients, equal), (loss, gradients, True)] on rank 0."""
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.parallel import comm, tp
    from mtl_tpu_torch.train.optim import (Adam, make_epoch_optimizer,
                                           make_meta_optimizers)
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step, make_meta_step)

    results = []
    for on_mesh in (True, False):
        if not (on_mesh or tpm.is_root):
            continue
        model = build_model(cfg, vocab_size, dev)
        model.load_state_dict(weights)
        if on_mesh:
            tp.shard_module(model, tpm.model)
        inner = {"meta": lambda: make_meta_optimizers(cfg)[1],
                 "joint": lambda: Adam(cfg.train.lr),
                 "epoch": lambda: make_epoch_optimizer(cfg)}[kind]()
        rec = _Recording(inner)
        state = init_train_state(model, rec)
        m = tpm if on_mesh else None
        if kind == "meta":
            _, met = make_meta_step(model, cfg, rec, mesh=m)(
                state, batch_to_device(sup, dev), batch_to_device(qry, dev))
            loss = met["outer_loss"]
        else:
            _, loss, _ = make_joint_step(model, cfg, rec, mesh=m)(
                state, batch_to_device(sup, dev))
        grads, equal = rec.grads, True
        if on_mesh:
            grads = tp.gather_tensors(grads, model.tp_layout, tpm.model)
            held = torch.cat([p.detach().reshape(-1) for n, p in
                              state.params.items()
                              if n not in model.tp_layout])
            every = comm.all_gather(held, tpm.world)
            equal = bool((every == every[0]).all())
        results.append((float(loss), {k: v.float().cpu()
                                      for k, v in grads.items()}, equal))
        del model, state, rec
    return results if tpm.is_root else None


def comm_all(torch, values, mesh):
    """Every rank's ``values`` (ints), gathered over the mesh."""
    from mtl_tpu_torch.parallel import comm

    t = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    return comm.all_gather(t, mesh.world).cpu().tolist()


def _bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def mesh_checks(torch, dev, corpus, ckpt, sp_manifest):
    """Phase 29, one 2-rank group sharing the card over gloo: f32 sharded
    meta steps, first and second order, and an emb_cnn epoch step with its
    BatchNorm synchronized, on (task 1, data 2), against the same steps in
    one process on the card (loss within 1e-5 relative, outer gradients
    within 1e-4 of the largest, the running statistics within 1e-5); the
    SP encode of one batch of 2 long utterances on (data 1, model 2)
    against the unsharded encode on the card, served bf16 (within one bf16
    ulp of the largest output), at f32 (within 1e-5 of it) and a 2-block
    Conformer at configs[4]'s width (bf16); each rank's launches of the
    VGG kernels on its haloed slice and its encode's peak memory beside
    the unsharded encode's."""
    from mtl_tpu_torch.config import Config, build_parser, config_from_args
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.parallel import launch

    cfg, vocab, support, query, weights, _ = _parity_inputs(torch, corpus)
    steps = []
    for name, second in (("meta step first order", False),
                         ("meta step second order", True)):
        cfg.train.second_order = second
        steps.append((name, cfg.to_json(), weights, support, query))
    cfg.train.second_order = False
    emb = Config.from_dict(json.loads(cfg.to_json()))
    emb.model.feat_extractor = "emb_cnn"
    emb.finalize()
    model = build_model(emb, len(vocab))
    init_weights(model, torch.Generator().manual_seed(SEED + 3))
    steps.append(("emb_cnn epoch step", emb.to_json(),
                  {k: v.clone() for k, v in model.state_dict().items()},
                  {k: v[:1] for k, v in support.items()}, None))
    encodes = []
    for dtype in ("bfloat16", "float32"):
        ecfg, _, sd, batch = _sp_batch(torch, ckpt, sp_manifest, dtype)
        encodes.append((f"SP encode {dtype}", ecfg.to_json(), sd, batch))
    ccfg = config_from_args(build_parser("").parse_args(
        CONFORMER_FLAGS + ["--num-enc-layers", "2", "--src-max-len",
                           "4000", "--dropout", "0"]))
    model = build_model(ccfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(SEED + 9))
    encodes.append(("SP encode Conformer 2 blocks d 1024 bfloat16",
                    ccfg.to_json(), model.state_dict(), batch))
    del model
    tp_steps = []
    for name, second, clip, kind in (
            ("TP meta step first order", False, False, "meta"),
            ("TP meta step second order --clip", True, True, "meta"),
            ("TP joint step", False, False, "joint"),
            ("TP Noam epoch step", False, False, "epoch")):
        tcfg = Config.from_dict(json.loads(cfg.to_json()))
        tcfg.train.second_order, tcfg.train.clip = second, clip
        sup = support if kind != "epoch" else {k: v[:1]
                                               for k, v in support.items()}
        tp_steps.append((name, tcfg.to_json(), weights, sup,
                         query if kind == "meta" else None, kind))
    tcfg = config_from_args(build_parser("").parse_args(
        CONFORMER_FLAGS + ["--num-enc-layers", "2", "--dtype", "float32",
                           "--dropout", "0"]))
    model = build_model(tcfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(SEED + 13))
    tp_steps.append(("TP Conformer meta step (2 blocks at configs[4]'s "
                     "width)", tcfg.to_json(), model.state_dict(), support,
                     query, "meta"))
    del model
    mcfg = Config()
    mcfg.mesh.data = 2
    _free(torch)
    t0 = time.perf_counter()
    out = launch.run(mcfg, dev, _mesh_check_rank, {
        "steps": steps, "encodes": encodes, "vocab": vocab,
        "tp_steps": tp_steps})
    print(f"mesh checks: 2 ranks over {launch.backend_for(dev, 2)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, _, _, _, _ in steps:
        (loss, grads, bufs), (want_loss, want, want_bufs) = out[name]
        scale = max(float(g.abs().max()) for g in want.values())
        err = max(float((grads[k] - g).abs().max())
                  for k, g in want.items())
        berr = max((float((bufs[k] - b).abs().max())
                    for k, b in want_bufs.items()), default=0.0)
        print(f"mesh parity {name} (f32, (task 1, data 2) vs one process, "
              f"the card): loss {loss:.7f} vs {want_loss:.7f}; outer "
              f"gradients max_abs_err {err:.3e} of max {scale:.3e}; "
              f"buffers max_abs_err {berr:.3e}", flush=True)
        check(math.isclose(loss, want_loss, rel_tol=1e-5)
              and err <= 1e-4 * scale and berr <= 1e-5,
              f"{name}: loss {loss} vs {want_loss}, grads {err}, "
              f"buffers {berr}")
    for name, _, _, _, _, _ in tp_steps:
        (loss, grads, equal), (want_loss, want, _) = out[name]
        scale = max(float(g.abs().max()) for g in want.values())
        err = max(float((grads[k] - g).abs().max())
                  for k, g in want.items())
        print(f"TP parity {name} (f32, (task 1, data 1, model 2) vs one "
              f"process, the card): loss {loss:.7f} vs {want_loss:.7f}; "
              f"outer gradients (gathered) max_abs_err {err:.3e} of max "
              f"{scale:.3e}; replicated leaves bitwise equal on both ranks "
              f"after the update: {equal}", flush=True)
        check(math.isclose(loss, want_loss, rel_tol=1e-5)
              and err <= 1e-4 * scale and equal
              and set(grads) == set(want),
              f"{name}: loss {loss} vs {want_loss}, grads {err}, replicated "
              f"leaves equal {equal}")
    for name, _, _, _ in encodes:
        got, want, every, plain_peak, slices = out[name]
        largest = float(want.abs().max())
        err = float((got - want).abs().max())
        bound = (1e-5 * max(1.0, largest) if "float32" in name
                 else _bf16_ulp(largest))
        print(f"{name} ({want.shape[1]} encoder frames, slices {slices}): "
              f"max_abs_err {err:.3e} (bound {bound:.3e}, largest "
              f"{largest:.3f}); VGG launches by rank "
              f"{[r[:4] for r in every]}; encode peak memory by rank "
              f"{[round(r[4] / 2**20, 1) for r in every]} MiB vs unsharded "
              f"{plain_peak / 2**20:.1f} MiB", flush=True)
        check(err <= bound, f"{name}: {err} > {bound}")
        f32 = "float32" in name
        check(all(r[2 * f32] == r[2 * f32 + 1] == 1
                  and r[2 - 2 * f32] == r[3 - 2 * f32] == 0 for r in every),
              f"{name}: each rank must launch its route's VGG kernels once "
              f"(on its haloed slice): {every}")


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

    if sys.argv[1:] == ["--tp-scaling"]:
        from mtl_tpu_torch.data.synthetic import make_synthetic_corpus

        corpus = os.path.join(WORK, "train_corpus")
        make_synthetic_corpus(corpus, num_tasks=K_TASKS, utts_per_task=16,
                              min_sec=4.0, max_sec=7.9, seed=SEED + 1)
        tp_scaling(torch, dev, corpus)
        return 0

    # 3. kernels against their plain versions; the VGG blocks at the
    # widths of other paths: 3b. log-fbank, 3c. 22.05 kHz
    records = check_kernels(torch, dev)
    check_kernels_width(torch, dev, FBANK_BINS, SEED + 7)
    check_kernels_width(torch, dev, BINS_22K, SEED + 22)

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

    # 6b. 22.05 kHz served through the direct STFT route
    counts_22k = serve_22k(torch, dev, WORK)

    # 8. beam serving with LM fusion at the flagship width
    t0 = time.perf_counter()
    manifest = os.path.join(corpus_dir, "manifest_task0.csv")
    labels_path = os.path.join(corpus_dir, "labels.json")
    fusion = build_lm(torch, dev, WORK)
    result_b, out_b, wall_b, beam_counts, peak_b = serve_beam(
        torch, dev, ckpt, manifest, labels_path, fusion)
    with open(os.path.join(WORK, "beam_main.txt"), "w",
              encoding="utf-8") as f:
        f.write(out_b)
    total = [ln for ln in out_b.splitlines() if ln.startswith("TOTAL CER")]
    preds = [ln for ln in out_b.splitlines() if ln.startswith("PRED:")]
    nbest = [ln for ln in out_b.splitlines() if ln.startswith("NBEST")]
    switched = result_b["switched_to_greedy"]
    check(len(total) == 1 and len(preds) == UTTERANCES
          and result_b["utterances"] == UTTERANCES
          and all(math.isfinite(result_b[k])
                  for k in ("cer", "wer", "en_cer", "zh_cer")),
          f"beam run: {len(preds)} PRED lines, {len(total)} TOTAL lines")
    print(total[0], flush=True)
    print(f"beam served {UTTERANCES} utterances ({audio_s:.3f} s of audio; "
          f"W {BEAM_W}, n-best {BEAM_NBEST}, LM fusion) in {wall_b:.3f} s: "
          f"{UTTERANCES / wall_b:.3f} utterances/s, real-time factor "
          f"{wall_b / audio_s:.4f}; {switched} of {batches} batches switched "
          f"to greedy; {len(nbest)} NBEST lines; peak memory "
          f"{peak_b:.1f} MiB", flush=True)
    print(f"launches in the beam run: {beam_counts}", flush=True)
    check(switched < batches and len(nbest) >= BEAM_NBEST,
          f"{switched} of {batches} batches switched to greedy, "
          f"{len(nbest)} NBEST lines")
    check(beam_counts["stft_logmag"] == batches
          and beam_counts["stft_logmag_direct"] == 0
          and beam_counts["vgg_block1"] == beam_counts["vgg_block2"]
          == batches + switched,
          f"the beam run must launch the FFT STFT once a batch ({batches}),"
          f" each bf16 VGG kernel once a batch and again for each batch "
          f"that switched to greedy ({switched}), the direct STFT never: "
          f"{beam_counts}")
    beam_batch(torch, dev, ckpt, manifest, fusion)
    beam_par = beam_parity(torch, dev, ckpt, manifest, fusion)
    print(f"launches in the f32 beam parity run: {beam_par}", flush=True)
    check(beam_par["vgg_block1_f32"] == beam_par["vgg_block2_f32"] == 1
          and beam_par["stft_logmag"] == 1, f"beam parity: {beam_par}")
    print(f"beam phases {time.perf_counter() - t0:.1f} s", flush=True)

    # 9. train the flagship width through the CLI; 10. f32 train parity
    t0 = time.perf_counter()
    _, train_corpus, meta_models = train(torch, dev, WORK)
    graph_checks(torch, dev, train_corpus)
    train_parity(torch, dev, train_corpus)
    print(f"train phases {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. joint training and finetune through the CLIs; 12. f32 parity
    t0 = time.perf_counter()
    joint(torch, dev, WORK, train_corpus, meta_models)
    joint_parity(torch, dev, train_corpus)
    print(f"joint phases {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the LM training mains; 14. LM step times; 15. LM f32 parity
    t0 = time.perf_counter()
    lm_tasks = lm_train(torch, dev, WORK)
    lm_timing(torch, dev, lm_tasks)
    lm_parity(torch, dev, lm_tasks)
    print(f"LM training phases {time.perf_counter() - t0:.1f} s", flush=True)

    # 16. MAML; 17. the discriminator heads; 18. the epoch trainer;
    # 19. their f32 steps against the CPU
    t0 = time.perf_counter()
    maml(torch, dev, WORK, train_corpus)
    disc_heads(torch, dev, WORK, train_corpus)
    epochs(torch, dev, WORK, train_corpus)
    maml_disc_epoch_parity(torch, dev, train_corpus)
    print(f"MAML, discriminator and epoch phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 20. the training options; 21. emb_cnn + CTC; 22. log-fbank;
    # 23. their f32 parity against the CPU
    t0 = time.perf_counter()
    options(torch, dev, WORK, train_corpus)
    emb_cnn_ctc(torch, dev, WORK, train_corpus)
    log_fbank(torch, dev, WORK, train_corpus)
    slice_parity(torch, dev, train_corpus)
    print(f"options, emb_cnn + CTC and log-fbank phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 24. the Conformer at configs[4]'s width served; 25. first-order
    # meta-transfer with --remat; 26. configs[4]'s training mode (second
    # order, remat) and a second-order MAML step; 27. their f32 parity and
    # remat on the card
    t0 = time.perf_counter()
    conformer_serve(torch, dev, corpus_dir, os.path.join(WORK, "models"))
    _, conformer_peak = conformer_train(torch, dev, WORK, train_corpus)
    conformer_second_order(torch, dev, WORK, train_corpus)
    conformer_parity(torch, dev, train_corpus)
    print(f"Conformer, second-order and remat phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 28. the task mesh through meta_transfer_train_main; 29. f32 sharded
    # steps and SP encodes against one process; 30. sequence-parallel
    # serving through test_main --mesh-model 2
    t0 = time.perf_counter()
    mesh_argv, single, single_peak, single_bytes = mesh_train(
        torch, dev, train_corpus)
    sp_manifest, sp_labels = _sp_corpus(WORK)
    mesh_checks(torch, dev, train_corpus, ckpt, sp_manifest)
    sp_serve(torch, dev, ckpt, sp_manifest, sp_labels)
    print(f"mesh and sequence-parallel phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 31. tensor-parallel meta training at the flagship width beside
    # phase 28's one process; 32. at configs[4]'s width
    t0 = time.perf_counter()
    tp_train(torch, dev, mesh_argv, single, single_peak, single_bytes)
    tp_conformer(torch, dev, WORK, train_corpus, conformer_peak)
    print(f"tensor-parallel phases {time.perf_counter() - t0:.1f} s",
          flush=True)

    # each kernel route must have run on its path: the bf16 tensor-core VGG
    # kernels and the FFT STFT on the served path, the f32 VGG kernels on
    # the f32 parity path, the direct STFT on the 22.05 kHz served path
    by_path = {"serve": counts, "parity": parity, "serve22k": counts_22k}
    for r in records:
        r["launches"] = by_path[r.pop("_path")].get(r["name"], 0)
        del r["_bound_note"]
    missing = [r["name"] for r in records if r["launches"] < 1]
    if missing:
        raise RuntimeError(f"kernels not launched on their path: {missing}")

    # 33. results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
