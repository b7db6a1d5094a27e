"""Typed configuration for the whole framework, with argparse shims that
accept the reference CLI flags (meta_transfer_train.py:20-107,
joint_train.py:20-122, train.py:19-107, finetune.py, test.py).

A copy of mtl_tpu/config.py for the PyTorch port, plus ``--device``: entry
points run on ``cuda`` unless the caller asks for ``cpu``. ``--cuda``,
``--use-pallas`` and ``--fused-vgg`` are accepted for CLI compatibility and
select nothing: on a CUDA device the STFT and VGG stages always run the
port's CUDA kernels.

One dataclass replaces the reference's ~50-flag `args` namespace that is passed
everywhere and pickled into checkpoints; we serialize it as JSON instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class AudioConfig:
    """Log-spectrogram front-end parameters.

    Parity: utils/data_loader.py:65-96 (librosa STFT with
    n_fft = sample_rate * window_size, hop = sample_rate * window_stride,
    hamming window, log1p magnitude, per-utterance mean/std normalize).
    """

    sample_rate: int = 16000
    window_size: float = 0.02
    window_stride: float = 0.01
    window: str = "hamming"
    normalize: bool = True
    augment: bool = False
    noise_dir: Optional[str] = None
    noise_prob: float = 0.4
    noise_min: float = 0.0
    noise_max: float = 0.5
    feat: str = "spectrogram"  # spectrogram | logfbank
    use_pallas: bool = False  # fused Pallas STFT kernel (TPU only)

    @property
    def n_fft(self) -> int:
        return int(self.sample_rate * self.window_size)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride)

    @property
    def num_freq(self) -> int:
        return self.n_fft // 2 + 1  # 161 at 16 kHz / 20 ms


@dataclass
class ModelConfig:
    """Transformer ASR model dimensions (reference README.md:47-61 defaults)."""

    feat_extractor: str = "vgg_cnn"  # vgg_cnn | emb_cnn | large_cnn | none
    num_enc_layers: int = 2
    num_dec_layers: int = 4
    num_heads: int = 8
    dim_model: int = 512
    dim_key: int = 64
    dim_value: int = 64
    dim_input: int = 161  # recomputed from feat_extractor + sample config
    dim_inner: int = 512
    dim_emb: int = 512
    src_max_len: int = 2500
    tgt_max_len: int = 1000
    dropout: float = 0.1
    emb_trg_sharing: bool = False
    is_factorized: bool = False
    r: int = 100
    # TPU-native knobs (no reference equivalent)
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    encoder_type: str = "transformer"  # transformer | conformer | e_branchformer
    remat: bool = False  # jax.checkpoint over encoder layers
    remat_conv: bool = False  # recompute conv activations in backward:
    # the flagship step is HBM-bound on full-resolution vgg activations
    # (BASELINE.md roofline) — remat trades cheap FLOPs for that traffic
    # e_branchformer only, named and defaulted as ESPnet's
    # EBranchformerEncoder: the macaron FFNs' hidden width, the cgMLP's
    # (value and gate halves), the gate's and the merge's depthwise kernels
    linear_units: int = 2048
    cgmlp_linear_units: int = 2048
    cgmlp_conv_kernel: int = 31
    merge_conv_kernel: int = 3
    fused_vgg: bool | None = None  # channel-leading Pallas VGG kernels
    # (opt-in --fused-vgg; measured slower end-to-end than XLA convs on v5e,
    # kept for the decode-only path and further kernel iteration)

    def computed_dim_input(self, num_freq: int, feat: str = "spectrogram") -> int:
        """Encoder input width after the conv front-end.

        Parity: utils/functions.py:307-328 (vgg: floor(floor(F/2)/2)*128;
        large: *64; emb_cnn: valid-conv arithmetic * 32).
        """
        if self.feat_extractor == "vgg_cnn":
            if feat == "logfbank":
                return 2560
            return (num_freq // 2 // 2) * 128
        if self.feat_extractor == "large_cnn":
            return (num_freq // 2 // 2) * 64
        if self.feat_extractor == "emb_cnn":
            h = num_freq
            h = (h - 41) // 2 + 1
            h = (h - 21) // 2 + 1
            return h * 32
        return self.dim_input


@dataclass
class TrainConfig:
    """Optimization / training-loop parameters."""

    loss: str = "ce"  # ce | ctc
    label_smoothing: float = 0.0
    lr: float = 1e-4  # plain/joint lr; meta: inner SGD lr
    meta_lr: float = 1e-4  # meta: outer Adam lr
    momentum: float = 0.9
    lr_anneal: float = 1.1
    k_lr: float = 1.0  # Noam factor
    min_lr: float = 1e-6
    warmup: int = 4000
    clip: bool = False
    max_norm: float = 400.0
    epochs: int = 1000  # interpreted as num iterations by iteration trainers
    k_train: int = 8
    k_valid: int = 8
    evaluate_every: int = 1000
    save_every: int = 5
    early_stop: str = "loss,10"
    copy_grad: bool = False  # first-order MAML (reference --copy-grad)
    opt_name: str = "adam"  # joint/finetune optimizer: adam | sgd
    seed: int = 123456
    # adversarial / multitask heads (joint_train.py:115-122)
    multitask: bool = False
    adversarial: bool = False
    num_class: int = 3
    beta: float = 0.5
    beta_decay: bool = False
    lr_disc: float = 1e-4
    # TPU-native knobs
    second_order: bool = False  # grad through inner SGD (true MAML)
    # task loop as lax.scan instead of vmap in the first-order meta step.
    # None = auto: scan on a data-sharded mesh (vmapped per-task conv
    # kernels force feature-group lowering whose reshapes break SPMD
    # propagation -> multi-GB activation all-gathers; steps.py), vmap
    # single-device (marginally better fusion).
    scan_tasks: Optional[bool] = None
    train_cer_every: int = 1  # compute train CER every N iterations (host sync)
    profile_dir: str = ""  # torch.profiler trace with the program's spans
    device_cer: bool = False  # compute train CER on device (two scalars to
    # host instead of decoding token matrices into strings every iteration)
    # Host-feed scaling: N prefetch workers computing future iterations
    # concurrently (each iteration's draw is seeded by (seed, it), so the
    # batch stream is identical for ANY worker count — trainer.py:
    # MultiWorkerPrefetcher). 1 = the reference's double-buffer thread.
    prefetch_workers: int = 1


@dataclass
class DecodeConfig:
    beam_search: bool = False
    beam_width: int = 3
    beam_nbest: int = 5
    lm_rescoring: bool = False
    lm_path: str = "lm_model.pt"
    lm_weight: float = 0.1
    c_weight: float = 0.1
    prob_weight: float = 1.0
    max_steps: int = 300  # reference greedy loop bound (modules/decoder.py:145)


@dataclass
class DataConfig:
    train_manifest_list: List[str] = field(default_factory=list)
    valid_manifest_list: List[str] = field(default_factory=list)
    test_manifest_list: List[str] = field(default_factory=list)
    train_partition_list: Optional[List[float]] = None
    labels_path: str = "labels.json"
    input_type: str = "char"
    num_workers: int = 8
    batch_size: int = 8
    # Static-shape bucketing (TPU-native; reference pads dynamically per batch)
    src_bucket_frames: Tuple[int, ...] = (200, 400, 800, 1600, 2500)
    tgt_bucket_len: Tuple[int, ...] = (32, 64, 128, 256)
    wave_cache_size: int = 2048  # decoded-waveform LRU entries (0 = off)


@dataclass
class MeshConfig:
    """Device-mesh axes for scale-out (no reference equivalent; the reference
    is single-device — SURVEY.md §2.6)."""

    data: int = 1  # data-parallel axis size (0/1 = all remaining devices)
    task: int = 1  # task-parallel axis for the meta loops
    model: int = 1  # tensor-parallel axis (stretch Conformer config)


@dataclass
class Config:
    name: str = "model"
    model_type: str = "TRFS"
    save_folder: str = "models/"
    continue_from: str = ""
    verbose: bool = False
    cuda: bool = False  # accepted for CLI parity; ignored
    device: str = "cuda"  # torch device of the entry points (cuda | cpu)
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def finalize(self) -> "Config":
        """Recompute derived dims (reference init_transformer_model does this
        mutation on `args` at utils/functions.py:307-328)."""
        self.model.dim_input = self.model.computed_dim_input(
            self.audio.num_freq, self.audio.feat
        )
        return self

    # ---- serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        sub_map = {
            "audio": AudioConfig, "model": ModelConfig,
            "train": TrainConfig, "decode": DecodeConfig,
            "data": DataConfig, "mesh": MeshConfig,
        }

        def build(dc_cls, dd):
            kwargs = {}
            for f in dataclasses.fields(dc_cls):
                if f.name not in dd:
                    continue
                v = dd[f.name]
                if isinstance(v, dict) and dc_cls is Config and f.name in sub_map:
                    kwargs[f.name] = build(sub_map[f.name], v)
                elif f.name in ("src_bucket_frames", "tgt_bucket_len"):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
            return dc_cls(**kwargs)

        return build(cls, d)


# --------------------------------------------------------------------------
# argparse shims — accept the exact reference flag spellings.
# --------------------------------------------------------------------------

def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="TRFS", type=str)
    p.add_argument("--name", default="model")
    p.add_argument("--train-manifest-list", nargs="+", type=str, default=[])
    p.add_argument("--valid-manifest-list", nargs="+", type=str, default=[])
    p.add_argument("--test-manifest-list", nargs="+", type=str, default=[])
    p.add_argument("--train-partition-list", nargs="+", type=float, default=None)
    p.add_argument("--sample-rate", default=16000, type=int)
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--k-train", default=8, type=int)
    p.add_argument("--k-valid", default=8, type=int)
    p.add_argument("--k-test", default=8, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--labels-path", default="labels.json")
    p.add_argument("--label-smoothing", default=0.0, type=float)
    p.add_argument("--window-size", default=0.02, type=float)
    p.add_argument("--window-stride", default=0.01, type=float)
    p.add_argument("--window", default="hamming")
    p.add_argument("--epochs", default=1000, type=int)
    p.add_argument("--cuda", dest="cuda", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (cuda | cpu); cuda raises if absent")
    p.add_argument("--early-stop", default="loss,10", type=str)
    p.add_argument("--save-every", default=5, type=int)
    p.add_argument("--save-folder", default="models/")
    p.add_argument("--emb-trg-sharing", action="store_true")
    p.add_argument("--feat_extractor", default="vgg_cnn", type=str)
    p.add_argument("--feat", type=str, default="spectrogram")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--continue-from", default="", type=str)
    p.add_argument("--augment", dest="augment", action="store_true")
    p.add_argument("--noise-dir", default=None)
    p.add_argument("--noise-prob", default=0.4, type=float)
    p.add_argument("--noise-min", default=0.0, type=float)
    p.add_argument("--noise-max", default=0.5, type=float)
    # Transformer dims
    p.add_argument("--num-layers", default=3, type=int)  # train.py spelling
    p.add_argument("--num-enc-layers", default=3, type=int)
    p.add_argument("--num-dec-layers", default=3, type=int)
    p.add_argument("--num-heads", default=5, type=int)
    p.add_argument("--dim-model", default=512, type=int)
    p.add_argument("--dim-key", default=64, type=int)
    p.add_argument("--dim-value", default=64, type=int)
    p.add_argument("--dim-input", default=161, type=int)
    p.add_argument("--dim-inner", default=1024, type=int)
    p.add_argument("--dim-emb", default=512, type=int)
    p.add_argument("--src-max-len", default=2500, type=int)
    p.add_argument("--tgt-max-len", default=1000, type=int)
    # optimizer
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--meta-lr", default=1e-4, type=float)
    p.add_argument("--opt_name", default="adam", type=str)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--lr-anneal", default=1.1, type=float)
    p.add_argument("--k-lr", default=1.0, type=float)
    p.add_argument("--min-lr", default=1e-6, type=float)
    p.add_argument("--warmup", default=4000, type=int)
    p.add_argument("--evaluate-every", default=1000, type=int)
    # decode
    p.add_argument("--beam-search", action="store_true")
    p.add_argument("--beam-width", default=3, type=int)
    p.add_argument("--beam-nbest", default=5, type=int)
    p.add_argument("--lm-rescoring", action="store_true")
    p.add_argument("--lm-path", type=str, default="lm_model.pt")
    p.add_argument("--lm-weight", default=0.1, type=float)
    p.add_argument("--c-weight", default=0.1, type=float)
    p.add_argument("--prob-weight", default=1.0, type=float)
    # loss
    p.add_argument("--loss", type=str, default="ce")
    p.add_argument("--clip", action="store_true")
    p.add_argument("--max-norm", default=400, type=float)
    p.add_argument("--is-factorized", action="store_true")
    p.add_argument("--r", default=100, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--input_type", type=str, default="char")
    # post-training factorization (accepted, unused — reference parity)
    p.add_argument("--rank", default=10, type=float)
    p.add_argument("--factorize", action="store_true")
    # meta
    p.add_argument("--copy-grad", action="store_true")
    p.add_argument("--cpu-state-dict", action="store_true")
    p.add_argument("--num-meta-test", default=0, type=int)
    # adversarial / multitask (joint_train.py:115-122)
    p.add_argument("--multitask", action="store_true")
    p.add_argument("--adversarial", action="store_true")
    p.add_argument("--num-class", default=3, type=int)
    p.add_argument("--beta", default=0.5, type=float)
    p.add_argument("--beta-decay", action="store_true")
    p.add_argument("--lr-disc", default=1e-4, type=float)
    # training mode selector (finetune.py / test.py)
    p.add_argument("--training-mode", default="meta", type=str)
    # TPU-native knobs
    p.add_argument("--dtype", default="bfloat16", type=str)
    p.add_argument("--use-pallas", action="store_true",
                   help="accepted for compatibility; the STFT always runs "
                        "the CUDA kernel on a CUDA device")
    p.add_argument("--profile-dir", default="", type=str,
                   help="write a torch.profiler trace of a few train "
                        "steps here, with the program's spans")
    p.add_argument("--device-cer", action="store_true",
                   help="compute train CER on device (no per-iteration host "
                        "string decode)")
    p.add_argument("--train-cer-every", default=1, type=int,
                   help="compute host-side train CER every N iterations")
    p.add_argument("--wave-cache-size", default=2048, type=int,
                   help="decoded-waveform cache entries per dataset (0 = off)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-conv", action="store_true")
    p.add_argument("--fused-vgg", dest="fused_vgg", default=None,
                   action="store_true",
                   help="accepted for compatibility; the VGG blocks "
                        "always run the CUDA kernels on a CUDA device")
    p.add_argument("--no-fused-vgg", dest="fused_vgg", action="store_false")
    p.add_argument("--encoder-type", default="transformer", type=str,
                   help="transformer (reference parity) | conformer | "
                        "e_branchformer (E-Branchformer, arXiv:2210.00077)")
    p.add_argument("--linear-units", default=2048, type=int,
                   help="e_branchformer: the macaron FFNs' hidden width")
    p.add_argument("--cgmlp-linear-units", default=2048, type=int,
                   help="e_branchformer: the cgMLP's width (value + gate)")
    p.add_argument("--cgmlp-conv-kernel", default=31, type=int,
                   help="e_branchformer: the cgMLP gate's depthwise kernel")
    p.add_argument("--merge-conv-kernel", default=3, type=int,
                   help="e_branchformer: the merge's depthwise kernel")
    p.add_argument("--second-order", action="store_true")
    p.add_argument("--scan-tasks", dest="scan_tasks", default=None,
                   action="store_true",
                   help="first-order meta step loops tasks via lax.scan "
                        "(default: auto — scan on a data-sharded mesh, "
                        "vmap single-device)")
    p.add_argument("--no-scan-tasks", dest="scan_tasks",
                   action="store_false")
    p.add_argument("--prefetch-workers", default=1, type=int,
                   help="host prefetch workers; iteration draws are seeded "
                        "by (seed, it) so the batch stream is identical for "
                        "any worker count (1 = double-buffer thread)")
    p.add_argument("--seed", default=123456, type=int)
    p.add_argument("--mesh-data", default=1, type=int)
    p.add_argument("--mesh-task", default=1, type=int)
    p.add_argument("--mesh-model", default=1, type=int)
    p.add_argument("--src-buckets", nargs="+", type=int, default=None)
    p.add_argument("--tgt-buckets", nargs="+", type=int, default=None)


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    _add_common_flags(p)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config(
        name=args.name,
        model_type=args.model,
        save_folder=args.save_folder,
        continue_from=args.continue_from,
        verbose=args.verbose,
        cuda=args.cuda,
        device=args.device,
        audio=AudioConfig(
            sample_rate=args.sample_rate,
            window_size=args.window_size,
            window_stride=args.window_stride,
            window=args.window,
            augment=args.augment,
            noise_dir=args.noise_dir,
            noise_prob=float(args.noise_prob),
            noise_min=args.noise_min,
            noise_max=args.noise_max,
            feat=args.feat,
            use_pallas=args.use_pallas,
        ),
        model=ModelConfig(
            feat_extractor=args.feat_extractor,
            num_enc_layers=args.num_enc_layers,
            num_dec_layers=args.num_dec_layers,
            num_heads=args.num_heads,
            dim_model=args.dim_model,
            dim_key=args.dim_key,
            dim_value=args.dim_value,
            dim_input=args.dim_input,
            dim_inner=args.dim_inner,
            dim_emb=args.dim_emb,
            src_max_len=args.src_max_len,
            tgt_max_len=args.tgt_max_len,
            dropout=args.dropout,
            emb_trg_sharing=args.emb_trg_sharing,
            is_factorized=args.is_factorized,
            r=args.r,
            dtype=args.dtype,
            remat=args.remat,
            remat_conv=args.remat_conv,
            fused_vgg=args.fused_vgg,
            encoder_type=args.encoder_type,
            linear_units=args.linear_units,
            cgmlp_linear_units=args.cgmlp_linear_units,
            cgmlp_conv_kernel=args.cgmlp_conv_kernel,
            merge_conv_kernel=args.merge_conv_kernel,
        ),
        train=TrainConfig(
            loss=args.loss,
            label_smoothing=args.label_smoothing,
            lr=args.lr,
            meta_lr=args.meta_lr,
            momentum=args.momentum,
            lr_anneal=args.lr_anneal,
            k_lr=args.k_lr,
            min_lr=args.min_lr,
            warmup=args.warmup,
            clip=args.clip,
            max_norm=args.max_norm,
            epochs=args.epochs,
            k_train=args.k_train,
            k_valid=args.k_valid,
            evaluate_every=args.evaluate_every,
            save_every=args.save_every,
            early_stop=args.early_stop,
            copy_grad=args.copy_grad,
            opt_name=args.opt_name,
            seed=args.seed,
            multitask=args.multitask,
            adversarial=args.adversarial,
            num_class=args.num_class,
            beta=args.beta,
            beta_decay=args.beta_decay,
            lr_disc=args.lr_disc,
            second_order=args.second_order,
            scan_tasks=args.scan_tasks,
            profile_dir=args.profile_dir,
            device_cer=args.device_cer,
            train_cer_every=args.train_cer_every,
            prefetch_workers=args.prefetch_workers,
        ),
        decode=DecodeConfig(
            beam_search=args.beam_search,
            beam_width=args.beam_width,
            beam_nbest=args.beam_nbest,
            lm_rescoring=args.lm_rescoring,
            lm_path=args.lm_path,
            lm_weight=args.lm_weight,
            c_weight=args.c_weight,
            prob_weight=args.prob_weight,
        ),
        data=DataConfig(
            train_manifest_list=args.train_manifest_list,
            valid_manifest_list=args.valid_manifest_list,
            test_manifest_list=args.test_manifest_list,
            train_partition_list=args.train_partition_list,
            labels_path=args.labels_path,
            input_type=args.input_type,
            num_workers=args.num_workers,
            batch_size=getattr(args, "batch_size", 8),
            wave_cache_size=args.wave_cache_size,
        ),
        mesh=MeshConfig(
            data=args.mesh_data, task=args.mesh_task, model=args.mesh_model
        ),
    )
    if args.src_buckets:
        cfg.data.src_bucket_frames = tuple(args.src_buckets)
    if args.tgt_buckets:
        cfg.data.tgt_bucket_len = tuple(args.tgt_buckets)
    return cfg.finalize()
