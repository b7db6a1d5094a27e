"""Driver of the meta-transfer training cells: what
``train/trainer.py:TrainerBase._loop`` does each iteration, in a closed
loop for the window.

Set-up writes the corpus, builds the program's model on the card, loads
the benchmark's weights into it, builds one trainer (``TransientTrainer``,
or ``MetaTrainer`` for a per-task query), its outer optimizer, its step and
its state, and starts the program's ``Prefetcher`` over ``trainer.fetch``.
The first ``checked_steps`` iterations run through that same loop body and
are recorded for the correctness check; they also warm every kernel. Then
the window: iteration after iteration (the prefetched batch, ``run_step``,
the loss read, ``_train_cer``) until ``--seconds`` have passed; only whole
steps count. With ``--trace 1`` the window (profiler off) gives the time
for ``mfu.train`` and the spans, and ``profiled_steps`` more iterations run
under torch.profiler.

The check (``reference/check.py``) follows the first three steps with the
plain reference in f32: each step's outer loss, the first outer gradient
as Adam got it (its first moment after one step over 1 - b1) and the
weights' change after three steps, each leaf's norm against the
reference's.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402
import roofline  # noqa: E402
from corpus import make_corpus  # noqa: E402
from reference import check  # noqa: E402
from reference.params import param_shapes  # noqa: E402
from reference.weights import make_weights  # noqa: E402

SPANS = ("data_wait", "run_step", "loss_read", "train_cer")


def build(cell, corpus, seeds):
    """(vocab, dataset, model, trainer, optimizer, step, state) of the
    program, with the benchmark's weights."""
    import torch
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.train.steps import init_train_state
    from mtl_tpu_torch.train.trainer import MetaTrainer, TransientTrainer

    c, tr = cell.config, cell.traffic
    cfg = harness.program_config(
        c, **{"train.seed": seeds["data"], "train.k_train": tr["k_train"],
              "train.k_valid": tr["k_valid"]})
    cfg.data.labels_path = corpus["labels"]
    cfg.data.train_manifest_list = corpus["manifests"]
    vocab = Vocab.from_json(corpus["labels"])
    dataset = SpectrogramDataset(vocab, cfg, corpus["manifests"],
                                 normalize=True, augment=False, is_train=True,
                                 seed=cfg.train.seed)
    device = torch.device(cell.device)
    with device:
        model = build_model(cfg, len(vocab))
    model.to(device)
    shapes = param_shapes(c, len(vocab))
    mine = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if mine != shapes:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"configuration's: {sorted(set(mine.items()) ^ set(shapes.items()))[:8]}")
    weights = make_weights(shapes, seeds["weights"], device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    del weights
    trainer_cls = MetaTrainer if c["per_task_query"] else TransientTrainer
    trainer = trainer_cls(model, cfg, vocab, device)
    opt = trainer.make_optimizer()
    step_fn = trainer.make_step(opt)
    state = init_train_state(model, opt)
    return vocab, dataset, model, trainer, opt, step_fn, state


def run(cell) -> harness.Outcome:
    import torch
    from mtl_tpu_torch.train.trainer import Prefetcher

    c, tr = cell.config, cell.traffic
    seeds = harness.derived_seeds(cell.seed)
    cuda = cell.device.startswith("cuda")
    root = os.path.join(cell.tmp, "corpus")
    marks = harness.Marks(cell.t0)
    marks("import and CUDA")
    corpus = make_corpus(root, c, tr, cell.seed)
    marks("corpus")
    vocab, dataset, model, trainer, opt, step_fn, state = build(
        cell, corpus, seeds)
    marks("model, weights, trainer")
    generator = torch.Generator(cell.device).manual_seed(seeds["dropout"])
    spans = harness.Spans()
    k = len(tr["tasks"])
    per_step = k * (tr["k_train"] + tr["k_valid"])
    shapes = []  # (frames, labels) of each step's batch

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prefetch = Prefetcher(lambda: trainer.fetch(dataset))

    def one(it):
        nonlocal state
        with spans("data_wait"):
            batch = prefetch.get()
        with spans("run_step"):
            state, loss, hyp, gold, m = trainer.run_step(
                step_fn, state, batch, generator, 0.5)
        with spans("loss_read"):
            loss = float(loss)
        with spans("train_cer"):
            trainer._train_cer(hyp, gold, m, it)
        support = batch[0]
        shapes.append((support["audio"].shape[-1], support["targets"].shape[-1]))
        return loss

    try:
        # the checked steps: the first iterations of the loop itself
        params = list(state.params.values())
        p0 = [p.detach().clone() for p in params]
        losses, g1 = [], None
        for it in range(tr["checked_steps"]):
            losses.append(one(it))
            marks(f"step {it + 1}")
            if it == 0:
                mu = [state.opt_state.mu[n] for n in state.params]
                g1 = [float(x) / (1.0 - opt.b1)
                      for x in torch._foreach_norm(mu)]
        delta = [float(x) for x in torch._foreach_norm(
            torch._foreach_sub([p.detach() for p in params], p0))]
        del p0, params
        names = list(state.params)
        sync()
        setup_s = time.perf_counter() - cell.t0
        marks("norms")
        marks.log()
        spans.total.clear()
        spans.count.clear()
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        # the window
        it = tr["checked_steps"]
        first = len(shapes)
        t_start = time.perf_counter()
        steps = 0
        step_s, t_prev = [], t_start
        with harness.HostProbe() as probe:
            while True:
                one(it)
                it += 1
                steps += 1
                t_end = time.perf_counter()
                step_s.append(t_end - t_prev)
                t_prev = t_end
                if t_end - t_start >= cell.seconds:
                    break
        window_s = t_end - t_start
        data_wait_ms = spans.mean_ms("data_wait")
        harness.log_window(step_s, spans, probe, window_s)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        window_shapes = shapes[first:]
        e2e = {"train_utt_per_s": steps * per_step / window_s,
               "setup_s": setup_s}
        if cuda:  # a device reading: none from a CPU run
            e2e["train_peak_gib"] = window_peak / 2 ** 30
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1,
                  "memory_peak_bytes": max(setup_peak, window_peak),
                  "power_limit_w": harness.power_limit_w() if cuda else None}
        trace = bd = None
        if cell.trace:
            trace, bd, busy_s, prof_s = _profiled(
                cell, one, it, spans, shapes, window_shapes, window_s, vocab,
                sync)
            trace["data_wait_ms"] = data_wait_ms
            device.update(busy_s=busy_s, window_s=prof_s)
    finally:
        prefetch.stop()

    # the program's state goes before the reference runs
    del model, trainer, opt, step_fn, state, prefetch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    detail = {}
    readings = check.meta_readings(
        c, corpus, seeds, tr, cell.device, len(vocab),
        {"losses": losses, "g1": dict(zip(names, g1)),
         "delta": dict(zip(names, delta))}, detail)
    print(f"check detail: {detail}; readings {readings}", file=sys.stderr)
    shutil.rmtree(root, ignore_errors=True)
    checks = {name: (readings[name], cell.limits[name])
              for name in cell.limits}
    return harness.Outcome(attempted=tr["checked_steps"] + steps,
                           failed=0, e2e=e2e, checks=checks,
                           trace=trace, device=device, breakdown=bd,
                           readings=readings)


def _profiled(cell, one, it, spans, shapes, window_shapes, window_s, vocab,
              sync):
    """The profiled steps after the window; returns (the trace the
    readers take, the breakdown, busy s, the profiled window's s)."""
    import torch
    from mtl_tpu_torch.ops import native

    c, tr = cell.config, cell.traffic
    k = len(tr["tasks"])
    n = tr["profiled_steps"]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = dict(native.launch_counts)
    first = len(shapes)
    spans.profiling = True
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(n):
            one(it + i)
        sync()
        prof_s = time.perf_counter() - t0
    spans.profiling = False
    launched = {key: native.launch_counts[key] - before[key]
                for key in before if native.launch_counts[key] > before[key]}
    print(f"kernel launches in the profiled steps: {launched}",
          file=sys.stderr)
    red = harness.reduce_profile(prof, list(SPANS))
    prof_shapes = shapes[first:]
    n_fft = int(c["sample_rate"] * c["window_size"])
    hop = int(c["sample_rate"] * c["window_stride"])
    f = n_fft // 2 + 1
    b_s, b_q = tr["k_train"], tr["k_valid"]
    query_batches = k if c["per_task_query"] else 1

    def frames(samples):
        return 1 + (samples - n_fft) // hop

    vgg_bound = sum(k * (roofline.vgg_stack_bound_s(b_s, frames(s), f)
                         + roofline.vgg_stack_bound_s(b_q, frames(s), f))
                    for s, _ in prof_shapes)
    stft_bound = sum(k * roofline.stft_bound_s(b_s, frames(s), n_fft, hop)
                     + query_batches * roofline.stft_bound_s(
                         b_q, frames(s), n_fft, hop)
                     for s, _ in prof_shapes)
    flops = sum(roofline.meta_step_flops(c, len(vocab), k, b_s, b_q,
                                         frames(s), l + 1)
                for s, l in window_shapes)
    groups = harness.group_ms(red)
    trace = {
        "steps": n,
        "host_ops": red["host_ops"],
        "gemm_ms": groups.get(harness.GEMM_GROUP, 0.0),
        "copy_cast_ms": groups.get(harness.COPY_GROUP, 0.0),
        "vgg_ms": harness.kernel_ms(
            red, lambda name: "vgg_block" in name and "_tc_kernel" in name
            and "f32" not in name),
        "vgg_bound_ms": vgg_bound * 1e3,
        "stft_ms": harness.kernel_ms(red, lambda name: "stft_fft" in name),
        "stft_bound_ms": stft_bound * 1e3,
        "busy_ms": red["busy_ms"],
        "window_ms": prof_s * 1e3,
        "flops": flops,
        "flops_window_s": window_s,
        "steps_in_window": len(window_shapes),
        "cuda": cell.device.startswith("cuda"),
    }
    return trace, harness.breakdown(red), red["busy_ms"] / 1e3, prof_s
