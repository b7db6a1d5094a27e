"""Driver of the greedy serving cells: the per-batch calls of
``cli/asr.py:_test``, batch after batch of the test manifest in manifest
order, pass after pass, for the window.

Set-up writes the corpus, loads the benchmark's weights through
``cli/common.py:load_asr_model`` (the serving copy), reads the manifest
once (the data set's wave cache then holds it, as on any later pass) and
serves one batch of every frame bucket the manifest's batches use. A batch
in the window: ``SpectrogramDataset.iter_batches`` (read and collate),
``train/steps.py:prepare_features``, ``model.prepare_decode``,
``decode/greedy.py:greedy_loop``, ``ids_to_strings`` (the latency ends
here, strings out), then the CER/WER scoring of ``utils/metrics.py``.

Random weights never emit EOS, so each batch decodes for the steps its
longest transcript needs plus one (capped at the configuration's
``max_steps``), as a trained model's EOS would end it: the traffic, not
the weights, sets the decode length.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402
import roofline  # noqa: E402
from corpus import make_corpus  # noqa: E402
from reference import check  # noqa: E402
from reference.params import param_shapes  # noqa: E402
from reference.weights import make_weights  # noqa: E402

SPANS = ("read_collate", "features", "prepare_decode", "greedy_loop",
         "to_strings", "score")


def run(cell) -> harness.Outcome:
    import torch
    from mtl_tpu_torch.cli.common import load_asr_model
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.vocab import Vocab, post_process
    from mtl_tpu_torch.decode.greedy import greedy_loop, ids_to_strings
    from mtl_tpu_torch.train.steps import prepare_features
    from mtl_tpu_torch.utils.metrics import calculate_cer, calculate_wer

    c, tr = cell.config, cell.traffic
    seeds = harness.derived_seeds(cell.seed)
    cuda = cell.device.startswith("cuda")
    if cuda:  # one host thread: the serving loop dispatches serially
        torch.set_num_threads(1)
    device = torch.device(cell.device)
    root = os.path.join(cell.tmp, "corpus")
    marks = harness.Marks(cell.t0)
    marks("import and CUDA")
    corpus = make_corpus(root, c, tr, cell.seed)
    marks("corpus")
    cfg = harness.program_config(c)
    cfg.data.labels_path = corpus["labels"]
    cfg.data.test_manifest_list = corpus["manifests"][:1]
    vocab = Vocab.from_json(corpus["labels"])
    weights = make_weights(param_shapes(c, len(vocab)), seeds["weights"],
                           device)
    model = load_asr_model(cfg, vocab, weights, device)
    del weights
    marks("model and weights")
    ds = SpectrogramDataset(vocab, cfg, corpus["manifests"][:1],
                            normalize=True)
    bsz = tr["batch"]
    sr = c["sample_rate"]
    spans = harness.Spans()
    records = []  # per served batch: (index, start, out, end, audio s, steps)
    served_ids = []  # per served batch: its ids on the host

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def serve(it, index, keep=True):
        t0 = time.perf_counter()
        with spans("read_collate"):
            batch, num_valid = next(it)
        with torch.inference_mode():
            with spans("features"):
                feats, lengths = prepare_features(
                    {k: torch.from_numpy(batch[k]).to(device)
                     for k in ("audio", "audio_lengths")}, cfg)
            with spans("prepare_decode"):
                _, enc_kvs = model.prepare_decode(feats, lengths)
            steps = min(cfg.decode.max_steps,
                        int((batch["targets"] != 0).sum(1).max()) + 1)
            with spans("greedy_loop"):
                ids = greedy_loop(model, enc_kvs, feats.shape[0], device,
                                  steps, vocab.SOS_ID)
            with spans("to_strings"):
                ids = ids.cpu()
                hyps = ids_to_strings(ids, vocab)
        t_out = time.perf_counter()
        with spans("score"):
            for hyp, row in list(zip(hyps, batch["targets"]))[:num_valid]:
                gold = post_process(vocab.decode_ids(row[row != 0]),
                                    vocab.special_token_list)
                hyp = post_process(hyp, vocab.special_token_list)
                calculate_cer(hyp.strip(), gold.strip())
                calculate_wer(hyp, gold)
        t_end = time.perf_counter()
        if keep:
            records.append((index, t0, t_out, t_end,
                            float(batch["audio_lengths"][:num_valid].sum()) / sr,
                            steps, feats.shape[1], num_valid))
            served_ids.append(ids.numpy())
        return feats.shape[1]

    def batches():
        return ds.iter_batches(bsz, shuffle=False, with_valid_count=True)

    n_batches = -(-len(corpus["utterances"][0]) // bsz)
    # set-up: one pass of reads (the wave cache), then one batch of every
    # frame bucket the manifest's batches take
    for _ in batches():
        pass
    marks("one pass of reads")
    first_of = {}
    for index in range(n_batches):
        first_of.setdefault(_frames(corpus, index, bsz, c), index)
    for index in sorted(first_of.values()):
        it = batches()
        for _ in range(index):
            next(it)
        serve(it, index, keep=False)
    sync()
    setup_s = time.perf_counter() - cell.t0
    marks(f"{len(first_of)} warm batches")
    marks.log()
    spans.total.clear()
    spans.count.clear()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # the window
    t_start = time.perf_counter()
    index, it = 0, batches()
    with harness.HostProbe() as probe:
        while True:
            if index == n_batches:
                index, it = 0, batches()
            serve(it, index)
            index += 1
            if records[-1][3] - t_start >= cell.seconds:
                break
    t_stop = records[-1][3]
    window_s = t_stop - t_start
    window = list(records)
    harness.log_window([r[3] - r[1] for r in window], spans, probe, window_s)
    lat_ms = [(r[2] - r[1]) * 1e3 for r in window for _ in range(r[7])]
    # the window's rate and tail swing with the host's speed (every span,
    # pure Python too, slows alike), so they are per-layer readings
    served = {"window_audio_s_per_s": sum(r[4] for r in window) / window_s,
              "window_p90_ms": float(np.percentile(lat_ms, 90))}
    print(f"served: {served}", file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"setup_s": setup_s}
    if cuda:  # a device reading: none from a CPU run
        e2e["serve_peak_gib"] = window_peak / 2 ** 30
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, window_peak),
           "power_limit_w": harness.power_limit_w() if cuda else None}
    trace = bd = None
    if cell.trace:
        loop_ms = spans.total.get("greedy_loop", 0.0) * 1e3
        decode_steps = sum(r[5] for r in window)
        host_batch_ms = spans.mean_ms("read_collate")
        trace, bd, busy_s, prof_s = _profiled(cell, serve, spans, batches,
                                              index, n_batches, records,
                                              window, window_s, len(vocab),
                                              sync)
        trace.update(decode_step_ms=loop_ms / decode_steps,
                     host_batch_ms=host_batch_ms, **served)
        dev.update(busy_s=busy_s, window_s=prof_s)

    # the check: a sample of the window's batches, the longest in it
    rng = np.random.RandomState(seeds["sample"])
    longest = max(range(len(window)), key=lambda i: window[i][5])
    others = [i for i in range(len(window)) if i != longest]
    pick = [longest] + list(rng.choice(
        others, min(len(others), tr["checked_batches"] - 1), replace=False))
    served = [{"index": window[i][0], "batch": bsz,
               "tokens": served_ids[i].astype(np.int64)} for i in pick]
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = check.served_gaps(c, corpus, seeds, cell.device, len(vocab),
                                 served)
    shutil.rmtree(root, ignore_errors=True)
    checks = {name: (readings[name], cell.limits[name])
              for name in cell.limits}
    return harness.Outcome(attempted=sum(r[7] for r in window), failed=0,
                           e2e=e2e, checks=checks, trace=trace, device=dev,
                           breakdown=bd,
                           readings=readings)


def _frames(corpus, index, bsz, c):
    """The frame bucket of batch ``index`` (from the corpus's sizes)."""
    utts = corpus["utterances"][0]
    hop = int(c["sample_rate"] * c["window_stride"])
    rows = [utts[(index * bsz + i) % len(utts)] for i in range(bsz)]
    frames = max(1 + min(u[3], (c["src_max_len"] - 1) * hop) // hop
                 for u in rows)
    return next((b for b in c["src_bucket_frames"] if frames <= b),
                c["src_bucket_frames"][-1])


def _profiled(cell, serve, spans, batches, index, n_batches, records,
              window, window_s, vocab_size, sync):
    """``profiled_batches`` more batches under torch.profiler; returns
    (the readers' trace, the breakdown, busy s, the profiled s)."""
    import torch

    c, tr = cell.config, cell.traffic
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    first = len(records)
    it = batches()
    for _ in range(index % n_batches):
        next(it)
    spans.profiling = True
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        i = index % n_batches
        for _ in range(tr["profiled_batches"]):
            if i == n_batches:
                i, it = 0, batches()
            serve(it, i)
            i += 1
        sync()
        prof_s = time.perf_counter() - t0
    spans.profiling = False
    red = harness.reduce_profile(prof, list(SPANS))
    prof_recs = records[first:]
    n_fft = int(c["sample_rate"] * c["window_size"])
    hop = int(c["sample_rate"] * c["window_stride"])
    f = n_fft // 2 + 1
    bsz = tr["batch"]
    steps = sum(r[5] for r in prof_recs)
    trace = {
        "batches": len(prof_recs),
        "launches_per_step": (harness.launches_in(red, "greedy_loop") / steps
                              if red["launches"] else None),
        "vgg_ms": harness.kernel_ms(
            red, lambda name: "vgg_block" in name and "_tc_kernel" in name
            and "f32" not in name),
        "vgg_bound_ms": 1e3 * sum(roofline.vgg_stack_bound_s(bsz, r[6], f)
                                  for r in prof_recs),
        "stft_ms": harness.kernel_ms(red, lambda name: "stft_fft" in name),
        "stft_bound_ms": 1e3 * sum(roofline.stft_bound_s(bsz, r[6], n_fft, hop)
                                   for r in prof_recs),
        "busy_ms": red["busy_ms"],
        "window_ms": prof_s * 1e3,
        "flops": sum(roofline.decode_flops(c, vocab_size, bsz, r[6], r[5])
                     for r in window),
        "flops_window_s": window_s,
        "cuda": cell.device.startswith("cuda"),
    }
    return trace, harness.breakdown(red), red["busy_ms"] / 1e3, prof_s
