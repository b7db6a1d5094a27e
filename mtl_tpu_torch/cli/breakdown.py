"""Where the time of one served batch goes, stage by stage.

    python -m mtl_tpu_torch.cli.breakdown --continue-from CKPT \\
        --test-manifest-list M.csv --labels-path L.json --k-test 8

Takes ``test_main``'s flags and checkpoint, and runs the stages of its loop
one at a time on the first batch of the first test manifest: host read and
collate, copy to the device, features (STFT kernel + normalize), VGG stack
(both VGG kernels), encoder, cross-attention K/V, the greedy decode loop,
and the host string cut. Each stage is ended by a device synchronize and
timed on the host clock; the first pass warms up and the second is kept.
On a CUDA device it then runs the features, the VGG stack and 20 decode
steps under ``torch.profiler``: for the first two it prints each kernel's
device time, for the decode steps the card's busy share (the profiler
slows the host, so that share is a lower bound).
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import build_parser, config_from_args
from ..data.dataset import SpectrogramDataset
from ..data.vocab import EOS_ID
from ..decode.greedy import greedy_loop, ids_to_strings
from ..train.steps import prepare_features
from ..utils.checkpoint import load_checkpoint
from .common import load_asr_model, resolve_device

PROFILED_STEPS = 20


def breakdown_main(argv=None):
    """Returns the stage times in ms and the number of decode steps run."""
    parser = build_parser("Stage times of one served batch (PyTorch port)")
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
    max_steps = cfg.decode.max_steps
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    ms = {}

    def stage(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):
            batch = stage("host_read_collate", lambda: next(
                ds.iter_batches(k_test, shuffle=False)))
            inp = stage("to_device", lambda: {
                k: torch.from_numpy(batch[k]).to(device)
                for k in ("audio", "audio_lengths")})
            feats, lengths = stage(
                "features", lambda: prepare_features(inp, saved_cfg))
            frames = stage("vgg_stack", lambda: model.conv(feats))
            enc = stage("encoder", lambda: model.encoder(frames, lengths))
            kvs = stage("cross_kv",
                        lambda: model.decoder.precompute_enc_kv(enc))
            ids = stage("decode_loop", lambda: greedy_loop(
                model, kvs, feats.shape[0], device, max_steps, vocab.SOS_ID))
            stage("to_strings", lambda: ids_to_strings(ids.cpu(), vocab))
        eos = ids == EOS_ID
        steps = int(torch.where(eos.any(1), eos.int().argmax(1) + 1,
                                ids.shape[1]).max())
        print(f"batch {tuple(feats.shape)}, {steps} decode steps; stage ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; {ms['decode_loop'] / steps:.3f} ms/step", flush=True)
        if device.type == "cuda":
            _profile_stage("features",
                           lambda: prepare_features(inp, saved_cfg))
            _profile_stage("vgg_stack", lambda: model.conv(feats))
            _profile_decode(model, kvs, feats.shape[0], device, vocab.SOS_ID)
    return ms, steps


def _device_kernels(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _short_name(kernel):
    """A kernel's name without return type, namespace noise, template
    arguments or parameters; kernels that share one are summed."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        name = name.split(cut)[0]
    return name


def _profile_stage(name, fn):
    """Device time of each kernel of one call of a stage, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in _device_kernels(prof):
        short = _short_name(e.name)
        by_name[short] = by_name.get(short, 0.0) + e.device_time / 1e3
    print(f"{name} under torch.profiler: {wall:.3f} ms wall, "
          f"{sum(by_name.values()):.3f} ms of device kernels: "
          + "; ".join(f"{k} {v:.4f}" for k, v in sorted(
              by_name.items(), key=lambda kv: -kv[1])), flush=True)


def _profile_decode(model, kvs, b, device, start_token):
    from torch.profiler import ProfilerActivity, profile

    caches = model.init_cache(b, PROFILED_STEPS + 1, device)
    y = torch.full((b,), start_token, dtype=torch.long, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(PROFILED_STEPS):
            logits, caches = model.decode_step(y, t, kvs, caches)
            y = logits.argmax(-1)
            bool((y == EOS_ID).all())  # the loop's host sync
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy = sum(e.device_time for e in kernels) / 1e3
    print(f"{PROFILED_STEPS} decode steps under torch.profiler: "
          f"{wall:.3f} ms wall, {busy:.3f} ms of device kernels "
          f"({len(kernels)} kernels): busy share "
          f"{busy / wall if kernels else float('nan'):.4f}", flush=True)


if __name__ == "__main__":
    breakdown_main(sys.argv[1:])
