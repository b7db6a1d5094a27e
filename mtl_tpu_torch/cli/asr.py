"""ASR CLI entry points of the port (mtl_tpu/cli/asr.py parity).

* ``meta_transfer_train_main`` — meta_transfer_train.py: the meta-transfer
  trainer (``TransientTrainer``; first order, or with ``--second-order``
  through the inner step), then with ``--num-meta-test N`` meta-test at
  the final weights, console script ``mtl-torch-meta-transfer-train``;
* ``meta_train_main`` — the same with MAML's per-task queries
  (``MetaTrainer``; the JAX package gives it no console script either);
* ``joint_train_main`` — joint_train.py: the joint trainer
  (``JointTrainer``: Adam, or ``--opt_name sgd``), console script
  ``mtl-torch-joint-train``;
* ``train_main`` — train.py: the epoch trainer (``EpochTrainer``, Noam
  Adam), console script ``mtl-torch-train``;
* ``finetune_main`` — finetune.py: the joint trainer from the
  ``--continue-from`` checkpoint (meta or joint), console script
  ``mtl-torch-finetune``. As in the JAX package, a resumed run takes its
  model and training settings from the checkpoint's config, with this
  invocation's manifests, iteration count, name and device;
* the trainers take the adversarial or multitask discriminator head with
  ``--adversarial`` / ``--multitask`` (``--beta-decay``, ``--lr-disc``,
  ``--num-class``);
* every entry point takes ``--encoder-type conformer`` or
  ``e_branchformer`` (``--linear-units``, ``--cgmlp-linear-units``,
  ``--cgmlp-conv-kernel``, ``--merge-conv-kernel``) and every trainer
  ``--remat`` / ``--remat-conv``;
* ``test_main`` — test.py: greedy or beam decode (``--beam-search``,
  optionally with LM shallow fusion, ``--lm-rescoring --lm-path``) of the
  test manifests from a port checkpoint, CER/WER + EN/ZH CER report; with
  ``--mesh-model M`` the long-form greedy path, its encode sequence-parallel
  over M ranks (``parallel/sp.py``).

The trainers take ``--mesh-task`` / ``--mesh-data`` / ``--mesh-model``
(tensor parallel, ``parallel/tp.py``): the calling process becomes rank 0
of the mesh of task x data x model ranks and starts the other ranks itself
(``parallel/launch.py``); it alone prints and returns. The mesh's refusals
(divisibility of the batch axes and of the split weights, ``--scan-tasks``,
the epoch trainer's task axis, an encoder that tensor parallel or the
sequence-parallel encode does not run) are raised before any rank starts,
as is ``--device cuda`` without a card.
"""

from __future__ import annotations

import time

import torch

from ..config import build_parser, config_from_args
from ..data.dataset import SpectrogramDataset
from ..data.vocab import post_process
from ..decode.beam import beam_search_grouped
from ..decode.greedy import greedy_search
from ..lm.fusion import LMScorer
from ..models.discriminator import Discriminator
from ..models.subsampler import subsampled_length
from ..models.transformer import build_model
from ..parallel import launch, tp
from ..parallel.mesh import requested_size
from ..parallel.sp import check_encoder, greedy_search_sp
from ..train.steps import prepare_features
from ..train.trainer import (EpochTrainer, JointTrainer, MetaTrainer,
                             TransientTrainer, check_mesh, meta_evaluate)
from ..utils.checkpoint import load_checkpoint, load_checkpoint_meta
from ..utils.logger import log_print
from ..utils.metrics import calculate_cer, calculate_cer_en_zh, calculate_wer
from .common import (build_datasets, build_vocab, load_asr_model,
                     maybe_resume, resolve_device, setup)


def _prepare(args, mesh=None):
    """(cfg, vocab, train set, valid sets, model on the device, device,
    start iteration, resumed metrics) of a training entry point, on this
    rank's device of ``mesh``."""
    cfg = config_from_args(args)
    device = resolve_device(cfg.device) if mesh is None else mesh.device
    setup(cfg)
    cfg, vocab, start_it, metrics = maybe_resume(cfg)
    if vocab is None:
        vocab = build_vocab(cfg)
    train_ds, valid_sets = build_datasets(cfg, vocab)
    model = build_model(cfg, len(vocab), device)
    return cfg, vocab, train_ds, valid_sets, model, device, start_it, metrics


def _discriminator(cfg, device):
    """The discriminator of ``--adversarial`` / ``--multitask``, else None
    (joint_train.py:115-122)."""
    if not (cfg.train.adversarial or cfg.train.multitask):
        return None
    return Discriminator(cfg.model.dim_model, cfg.train.num_class).to(device)


def _train_on_mesh(args, kind: str, run, *extra):
    """``run(mesh, args, *extra)`` on the mesh of ``--mesh-task`` /
    ``--mesh-data`` / ``--mesh-model`` (one process without one), after the
    refusals that need no rank: the device, ``kind``'s mesh checks on the
    run's (possibly resumed) config, and under tensor parallel a split
    weight dim that ``--mesh-model`` does not divide."""
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    if requested_size(cfg) > 1:
        resumed = maybe_resume(cfg)[0]
        disc = resumed.train.adversarial or resumed.train.multitask
        if kind != "epoch" and disc:
            kind = "joint"
        shape = launch.plan(cfg, device)
        check_mesh(resumed, shape, len(resumed.data.train_manifest_list),
                   kind)
        if shape[2] > 1 and not disc:
            tp.check_config(resumed, shape[2])
    return launch.run(cfg, device, run, args, *extra)


def meta_transfer_train_main(argv=None, trainer_cls=TransientTrainer):
    """meta_transfer_train.py parity (mtl_tpu/cli/asr.py:50-75): builds
    the vocab, datasets and model (from the checkpoint's config with
    ``--continue-from``), runs the meta-transfer trainer (or
    ``trainer_cls``) on ``--device``, then ``--num-meta-test`` trials of
    meta-test at the final weights. Returns the final ``TrainState``."""
    parser = build_parser("Transformer ASR meta training (PyTorch port)")
    return _train_on_mesh(parser.parse_args(argv), "meta", _meta_train,
                          trainer_cls)


def _meta_train(mesh, args, trainer_cls):
    cfg, vocab, train_ds, valid_sets, model, device, start_it, metrics = \
        _prepare(args, mesh)
    trainer = trainer_cls(model, cfg, vocab, device,
                          _discriminator(cfg, device), mesh=mesh)
    log_print("Transient Trainer is initialized"
              if trainer_cls is TransientTrainer
              else "Meta Trainer is initialized")
    state = trainer.train(train_ds, valid_sets, start_it=start_it,
                          num_it=cfg.train.epochs, last_metrics=metrics)
    if args.num_meta_test and valid_sets and trainer.evaluates:
        meta_evaluate(trainer, state.params, train_ds, valid_sets,
                      num_meta_test=args.num_meta_test)
    return state


def meta_train_main(argv=None):
    """MAML (mtl_tpu/cli/asr.py:78; reference meta_trainer.py): the meta
    trainer with every task's own query batch."""
    return meta_transfer_train_main(argv, trainer_cls=MetaTrainer)


def joint_train_main(argv=None):
    """joint_train.py parity (mtl_tpu/cli/asr.py:84-97): the joint trainer
    on ``--device``, with the discriminator head when asked. Returns the
    final ``TrainState``."""
    parser = build_parser("Transformer ASR joint training (PyTorch port)")
    return _train_on_mesh(parser.parse_args(argv), "joint", _joint_train)


def _joint_train(mesh, args):
    cfg, vocab, train_ds, valid_sets, model, device, start_it, metrics = \
        _prepare(args, mesh)
    trainer = JointTrainer(model, cfg, vocab, device,
                           _discriminator(cfg, device), mesh=mesh)
    return trainer.train(train_ds, valid_sets, start_it=start_it,
                         num_it=cfg.train.epochs, last_metrics=metrics)


def train_main(argv=None):
    """train.py parity (mtl_tpu/cli/asr.py:100-109): the epoch trainer on
    ``--device``; ``--continue-from`` a ``step_N`` checkpoint runs epochs
    N, N + 1, .... Returns the final ``TrainState``."""
    parser = build_parser("Transformer ASR epoch training (PyTorch port)")
    return _train_on_mesh(parser.parse_args(argv), "epoch", _epoch_train)


def _epoch_train(mesh, args):
    cfg, vocab, train_ds, valid_sets, model, device, start_epoch, _ = \
        _prepare(args, mesh)
    trainer = EpochTrainer(model, cfg, vocab, device, mesh=mesh)
    return trainer.train(train_ds, valid_sets, start_epoch=start_epoch,
                         num_epochs=cfg.train.epochs)


def finetune_main(argv=None):
    """finetune.py parity (mtl_tpu/cli/asr.py:112-119): the joint trainer
    from a meta or joint ``--continue-from`` checkpoint."""
    parser = build_parser("Transformer ASR finetuning (PyTorch port)")
    if not config_from_args(parser.parse_args(argv)).continue_from:
        raise ValueError("--continue-from is required for finetune")
    return joint_train_main(argv)


def test_main(argv=None):
    """test.py parity: load the checkpoint, decode the test manifests
    greedily or by beam search (+ LM fusion), report CER/WER + EN/ZH CER.
    Returns the four totals, the number of scored utterances and the
    number of beam batches that switched to greedy. With ``--mesh-model
    M`` (greedy only) the encode runs sequence-parallel on a mesh of
    ``--mesh-data`` x M ranks (mtl_tpu/cli/asr.py:143-227)."""
    parser = build_parser("Transformer ASR evaluation (PyTorch port)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    if cfg.mesh.model <= 1:
        return _test(None, args)
    if cfg.decode.beam_search:
        raise ValueError(
            "--mesh-model (sequence-parallel encode) currently supports "
            "greedy decode only; drop --beam-search or --mesh-model")
    if cfg.continue_from:
        check_encoder(load_checkpoint_meta(cfg.continue_from)[0]
                      .model.encoder_type)
    cfg.mesh.task = 1  # the sequence-parallel mesh: data x model
    return launch.run(cfg, device, _test, args)


def _test(mesh, args):
    cfg = config_from_args(args)
    device = resolve_device(cfg.device) if mesh is None else mesh.device
    setup(cfg)
    if not cfg.continue_from:
        raise ValueError("--continue-from is required for test")

    saved_cfg, vocab, state_dict, _, _ = load_checkpoint(cfg.continue_from)
    # decode/audio settings come from the CLI, model arch from the checkpoint
    saved_cfg.decode = cfg.decode
    saved_cfg.data = cfg.data
    if mesh is not None:
        # long-form utterances run past the trained cap: the CLI's
        # --src-max-len wins when larger (the PE table extends; no
        # parameter depends on it)
        saved_cfg.model.src_max_len = max(saved_cfg.model.src_max_len,
                                          cfg.model.src_max_len)
        log_print(f"sequence-parallel encode: time axis over "
                  f"model={mesh.shape['model']} "
                  f"(src_max_len={saved_cfg.model.src_max_len})")
    model = load_asr_model(saved_cfg, vocab, state_dict, device)
    lm = (LMScorer.load(cfg.decode.lm_path, device)
          if cfg.decode.lm_rescoring else None)

    test_sets = [
        SpectrogramDataset(vocab, saved_cfg, [m], normalize=True)
        for m in cfg.data.test_manifest_list
    ]
    total_cer = total_wer = total_char = total_word = 0
    total_en_cer = total_zh_cer = total_en_char = total_zh_char = 0
    num_utts = switched = 0
    start = time.time()
    k_test = getattr(args, "k_test", None) or cfg.train.k_valid
    nbest = max(1, cfg.decode.beam_nbest)
    with torch.inference_mode():
        for ds in test_sets:
            for batch, num_valid in ds.iter_batches(k_test, shuffle=False,
                                                    with_valid_count=True):
                feats, lengths = prepare_features(
                    {k: torch.from_numpy(batch[k]).to(device)
                     for k in ("audio", "audio_lengths")}, saved_cfg)
                nbest_lists = None
                if cfg.decode.beam_search:
                    # the reference's horizon: --tgt-max-len of the test
                    # CLI (test.py:65), every survivor retired at the
                    # encoder length (modules/decoder.py:215,253-255);
                    # --max-steps caps the bank's memory
                    enc_len = subsampled_length(
                        saved_cfg.model.feat_extractor, feats.shape[1])
                    horizon = min(cfg.model.tgt_max_len, max(enc_len, 1))
                    nbest_lists = beam_search_grouped(
                        model, feats, lengths, vocab,
                        beam_width=cfg.decode.beam_width, nbest=nbest,
                        max_steps=min(cfg.decode.max_steps, horizon),
                        start_token=vocab.SOS_ID,
                        c_weight=cfg.decode.c_weight, lm=lm,
                        lm_rescoring=cfg.decode.lm_rescoring,
                        lm_weight=cfg.decode.lm_weight)
                    hyps = [g[0][2] if g else "" for g in nbest_lists]
                    if len(hyps) == 0 or len(hyps[0].strip()) == 0:
                        # the reference's fallback to greedy when the
                        # first hypothesis is empty
                        # (models/asr/transformer.py:190-197)
                        log_print(">>>>>>> switch to greedy")
                        switched += 1
                        nbest_lists = None
                if mesh is not None:
                    hyps = greedy_search_sp(model, feats, lengths, vocab,
                                            cfg.decode.max_steps,
                                            vocab.SOS_ID, mesh)
                    if hyps is None:  # a rank other than 0: no scoring
                        continue
                elif nbest_lists is None:
                    hyps = greedy_search(model, feats, lengths, vocab,
                                         cfg.decode.max_steps, vocab.SOS_ID)
                golds = [
                    post_process(vocab.decode_ids(row),
                                 vocab.special_token_list)
                    for row in batch["targets"]
                ]
                # score only the real rows; the final ragged batch is
                # padded with duplicate utterances to keep shapes static
                hyps, golds = hyps[:num_valid], golds[:num_valid]
                num_utts += num_valid
                for ind, (hyp, gold) in enumerate(zip(hyps, golds)):
                    hyp = post_process(hyp, vocab.special_token_list)
                    # reference-exact scoring (test.py:138-158): CER over
                    # the STRIPPED strings, total chars include spaces,
                    # words split on single spaces
                    cer = calculate_cer(hyp.strip(), gold.strip())
                    wer = calculate_wer(hyp, gold)
                    en_d, zh_d, en_n, zh_n = calculate_cer_en_zh(hyp, gold)
                    total_cer += cer
                    total_wer += wer
                    total_char += len(gold)
                    total_word += len(gold.split(" "))
                    total_en_cer += en_d
                    total_zh_cer += zh_d
                    total_en_char += en_n
                    total_zh_char += zh_n
                    log_print(f"PRED: {hyp}")
                    log_print(f"GOLD: {gold}")
                    # n-best report (the reference appends every n-best,
                    # modules/decoder.py:286-291)
                    if nbest_lists is not None and nbest > 1:
                        for rank, (score, _, s) in enumerate(
                                nbest_lists[ind]):
                            s = post_process(s, vocab.special_token_list)
                            log_print(f"NBEST {rank + 1}: {score:.4f} {s}")
    log_print(
        "TOTAL CER: {:.2f}% WER: {:.2f}% EN CER: {:.2f}% ZH CER: {:.2f}% "
        "TIME: {:.2f}s".format(
            total_cer * 100.0 / max(total_char, 1),
            total_wer * 100.0 / max(total_word, 1),
            total_en_cer * 100.0 / max(total_en_char, 1),
            total_zh_cer * 100.0 / max(total_zh_char, 1),
            time.time() - start,
        )
    )
    return {
        "cer": total_cer * 100.0 / max(total_char, 1),
        "wer": total_wer * 100.0 / max(total_word, 1),
        "en_cer": total_en_cer * 100.0 / max(total_en_char, 1),
        "zh_cer": total_zh_cer * 100.0 / max(total_zh_char, 1),
        "utterances": num_utts,
        "switched_to_greedy": switched,
    }
