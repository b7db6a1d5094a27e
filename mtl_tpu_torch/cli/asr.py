"""ASR CLI entry points of the port (mtl_tpu/cli/asr.py parity).

* ``meta_transfer_train_main`` — meta_transfer_train.py: the first-order
  meta-transfer trainer (``TransientTrainer``), console script
  ``mtl-torch-meta-transfer-train``;
* ``test_main`` — test.py: greedy or beam decode (``--beam-search``,
  optionally with LM shallow fusion, ``--lm-rescoring --lm-path``) of the
  test manifests from a port checkpoint, CER/WER + EN/ZH CER report.
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
from ..models.subsampler import subsampled_length
from ..models.transformer import build_model
from ..train.steps import prepare_features
from ..train.trainer import TransientTrainer
from ..utils.checkpoint import load_checkpoint
from ..utils.logger import log_print
from ..utils.metrics import calculate_cer, calculate_cer_en_zh, calculate_wer
from .common import (build_datasets, build_vocab, load_asr_model,
                     maybe_resume, resolve_device, setup)


def meta_transfer_train_main(argv=None):
    """meta_transfer_train.py parity (mtl_tpu/cli/asr.py:50-75): builds
    the vocab, datasets and model (from the checkpoint's config with
    ``--continue-from``) and runs the first-order meta-transfer trainer on
    ``--device``. Returns the final ``TrainState``."""
    parser = build_parser("Transformer ASR meta training (PyTorch port)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    if args.num_meta_test:
        raise ValueError("--num-meta-test is not ported yet")
    setup(cfg)
    cfg, vocab, start_it, metrics = maybe_resume(cfg)
    if vocab is None:
        vocab = build_vocab(cfg)
    train_ds, valid_sets = build_datasets(cfg, vocab)
    model = build_model(cfg, len(vocab), device)
    trainer = TransientTrainer(model, cfg, vocab, device)
    log_print("Transient Trainer is initialized")
    return trainer.train(train_ds, valid_sets, start_it=start_it,
                         num_it=cfg.train.epochs, last_metrics=metrics)


def test_main(argv=None):
    """test.py parity: load the checkpoint, decode the test manifests
    greedily or by beam search (+ LM fusion), report CER/WER + EN/ZH CER.
    Returns the four totals, the number of scored utterances and the
    number of beam batches that switched to greedy."""
    parser = build_parser("Transformer ASR evaluation (PyTorch port)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    if cfg.mesh.model > 1:
        raise ValueError("--mesh-model is not ported yet")
    setup(cfg)
    if not cfg.continue_from:
        raise ValueError("--continue-from is required for test")

    saved_cfg, vocab, state_dict, _, _ = load_checkpoint(cfg.continue_from)
    # decode/audio settings come from the CLI, model arch from the checkpoint
    saved_cfg.decode = cfg.decode
    saved_cfg.data = cfg.data
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
                if nbest_lists is None:
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
