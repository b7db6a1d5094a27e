"""Where the time of one served batch goes, by the program's spans.

    python -m mtl_tpu_torch.cli.breakdown --continue-from CKPT \\
        --test-manifest-list M.csv --labels-path L.json --k-test 8

Takes ``test_main``'s flags and checkpoint and serves the first batch of
the first test manifest through the serving path: read and collate, copy
to the device, features (STFT kernel + normalize), the VGG stack, the
encoder, the cross-attention K/V, the greedy decode loop and the host
string cut, each under its span (``utils/trace.py``). The first pass warms
up. The second runs with the spans' totals on and prints each span's
count, host ms and self ms; nothing is synchronized but what the program
synchronizes itself, so the decode loop overlaps the device as it does
when serving. On a CUDA device a third pass runs under ``torch.profiler``
and prints each span's device ms, by kernel: a kernel counts under the
innermost span the host was in when it launched it.
"""

from __future__ import annotations

import sys

import torch

from ..config import build_parser, config_from_args
from ..data.dataset import SpectrogramDataset
from ..data.vocab import EOS_ID
from ..decode.greedy import greedy_loop, ids_to_strings
from ..train.steps import prepare_features
from ..utils import trace
from ..utils.checkpoint import load_checkpoint
from .common import load_asr_model, resolve_device

TOP_KERNELS = 4


def breakdown_main(argv=None):
    """Returns the spans' totals of the second pass and the number of
    decode steps the batch ran."""
    parser = build_parser("Span times of one served batch (PyTorch port)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    saved_cfg, vocab, state_dict, _, _ = load_checkpoint(cfg.continue_from)
    saved_cfg.decode = cfg.decode
    saved_cfg.data = cfg.data
    model = load_asr_model(saved_cfg, vocab, state_dict, device)
    ds = SpectrogramDataset(vocab, saved_cfg,
                            [cfg.data.test_manifest_list[0]], normalize=True)
    k_test = getattr(args, "k_test", None) or cfg.train.k_valid

    def serve():
        with trace.span("serve.read_collate"):
            batch = next(ds.iter_batches(k_test, shuffle=False))
        with trace.span("serve.to_device"):
            inp = {k: torch.from_numpy(batch[k]).to(device)
                   for k in ("audio", "audio_lengths")}
        feats, lengths = prepare_features(inp, saved_cfg)
        _, kvs = model.prepare_decode(feats, lengths)
        ids = greedy_loop(model, kvs, feats.shape[0], device,
                          cfg.decode.max_steps, vocab.SOS_ID)
        with trace.span("serve.to_strings"):
            ids = ids.cpu()
            ids_to_strings(ids, vocab)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return feats, ids

    with torch.inference_mode():
        serve()
        trace.reset()
        trace.enable()
        try:
            feats, ids = serve()
        finally:
            trace.disable()
        totals = trace.totals()
        trace.reset()
        eos = ids == EOS_ID
        steps = int(torch.where(eos.any(1), eos.int().argmax(1) + 1,
                                ids.shape[1]).max())
        print(f"batch {tuple(feats.shape)}, {steps} decode steps; host ms "
              f"by span:\n{trace.format_totals(totals)}", flush=True)
        if device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                serve()
            print(_format_device(_device_ms_by_span(prof.events(), totals)),
                  flush=True)
    return totals, steps


def _innermost(ranges, times):
    """For each of the sorted ``times``, the name of the innermost of the
    properly nested ``ranges`` [(start, end, name)] that holds it, or
    None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _device_ms_by_span(events, names):
    """{span or None: {kernel's short name: device ms}} of a profiled
    run's ``events``: each kernel or copy under the innermost of the
    ``names`` spans the host was in when its launch call ran (the call and
    the kernel share a correlation id)."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, launched_at, kernels = [], {}, []
    for e in events:
        if e.device_type == cuda:
            # a span's range on the device timeline is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in names):
                kernels.append(e)
        elif e.name in names:
            ranges.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("cu"):
            launched_at[e.id] = e.time_range.start
    kernels = sorted(kernels, key=lambda k: launched_at.get(k.id, -1.0))
    where = _innermost(ranges, [launched_at.get(k.id, -1.0)
                                for k in kernels])
    out = {}
    for k, s in zip(kernels, where):
        by_kernel = out.setdefault(s, {})
        name = _short_name(k.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + (
            k.time_range.end - k.time_range.start) / 1e3
    return out


def _format_device(by_span) -> str:
    rows = sorted(by_span.items(), key=lambda kv: -sum(kv[1].values()))
    lines = ["device ms by span under torch.profiler (heaviest kernels):"]
    for s, by_kernel in rows:
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
        lines.append(f"  {s or '(no span)':<20} "
                     f"{sum(by_kernel.values()):>9.3f}  "
                     + "; ".join(f"{k} {v:.4f}" for k, v in top))
    return "\n".join(lines)


def _short_name(kernel):
    """A kernel's name without return type, namespace noise, template
    arguments or parameters; kernels that share one are summed."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        name = name.split(cut)[0]
    return name.strip()


if __name__ == "__main__":
    breakdown_main(sys.argv[1:])
