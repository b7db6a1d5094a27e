"""LM CLI entry points of the port (mtl_tpu/cli/lm.py parity; reference
lm/main.py, main_joint.py, main_meta_transfer.py, finetune.py, test.py and
convert.py).

* ``main_main`` — lm/main.py: epoch training on one corpus (bptt windows,
  the carry detached per window, lr/4 on a validation plateau, patience
  5), then the test set's perplexity and per-word dump; ``mtl-torch-lm``;
* ``main_joint_main`` — lm/main_joint.py: ratio-weighted training over the
  listed corpora; ``mtl-torch-lm-joint``;
* ``main_meta_transfer_main`` — lm/main_meta_transfer.py: meta-transfer
  towards the last listed corpus, first order or ``--second-order``;
  ``mtl-torch-lm-meta-transfer``;
* ``finetune_main`` — lm/finetune.py: epoch training of ``--load`` on one
  corpus, keeping its dictionary; ``mtl-torch-lm-finetune``;
* ``test_main`` — lm/test.py: perplexity plus the code-switch transition
  breakdown of a saved LM on a corpus, and the per-word probability dump
  (``predictions/lm_test_<name>``); ``mtl-torch-lm-test``;
* ``convert_main`` — lm/convert.py: a saved LM re-saved as a fusion
  directory for ``test_main --lm-rescoring --lm-path``;
  ``mtl-torch-lm-convert``.

Flags are the reference's (``lm_parser``) plus ``--device`` (default
``cuda``, which raises without a card). The corpus lists (``--train-path-
list`` etc.) take the place of the reference's hardcoded CV/HKUST/SEAME
paths; the last listed corpus is the code-switched target and one
dictionary grows across them in listed order. An LM checkpoint is a
directory of ``meta.json`` ({arch, word2idx}) and ``model.pt`` (the f32
state_dict). The training mains keep the best weights as a copy (SGD
updates the parameters in place) and save them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..lm.data import Corpus, Dictionary, LMDataset, batchify, get_batch
from ..lm.fusion import load_lm_dir, save_lm_dir, save_lm_fusion
from ..lm.model import RNNLM, init_lm_weights
from ..lm.train import (evaluate_lm, evaluate_lm_test, joint_ratios,
                        make_lm_joint_step, make_lm_meta_step,
                        make_lm_sgd_step)
from ..utils.logger import log_print, setup_logging
from .common import resolve_device


def lm_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--name", type=str, default="")
    p.add_argument("--train_path", type=str, default=None)
    p.add_argument("--valid_path", type=str, default=None)
    p.add_argument("--test_path", type=str, default=None)
    p.add_argument("--train-path-list", nargs="+", type=str, default=None)
    p.add_argument("--valid-path-list", nargs="+", type=str, default=None)
    p.add_argument("--test-path-list", nargs="+", type=str, default=None)
    p.add_argument("--model", type=str, default="LSTM")
    p.add_argument("--emsize", type=int, default=200)
    p.add_argument("--nhid", type=int, default=200)
    p.add_argument("--nlayers", type=int, default=2)
    p.add_argument("--lr", type=float, default=20)
    p.add_argument("--meta_lr_factor", type=float, default=3)
    p.add_argument("--clip", type=float, default=0.25)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--bptt", type=int, default=35)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--tied", action="store_true")
    p.add_argument("--pad", action="store_true")
    p.add_argument("--seed", type=int, default=1111)
    p.add_argument("--cuda", action="store_true")
    p.add_argument("--log_path", type=str, default="./log")
    p.add_argument("--log-interval", type=int, default=200)
    p.add_argument("--valid-interval", type=int, default=600)
    p.add_argument("--num-iterations", type=int, default=0)
    p.add_argument("--save", type=str, default="./model")
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--second-order", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda | cpu); cuda raises if absent")
    return p


def _log_name(args, extra: str = "") -> str:
    return (f"{args.name}_model{args.model}_bptt{args.bptt}_lr{args.lr}"
            f"_drop{args.dropout}_layers{args.nlayers}_nhid{args.nhid}"
            f"_emsize{args.emsize}{extra}")


def build_lm(args, ntokens: int) -> RNNLM:
    """The LM of the flags; ``--second-order`` selects the cell loop."""
    return RNNLM(rnn_type=args.model, ntoken=ntokens, ninp=args.emsize,
                 nhid=args.nhid, nlayers=args.nlayers, dropout=args.dropout,
                 tie_weights=args.tied, cell_loop=args.second_order)


def _new_lm(args, ntokens: int, device: torch.device) -> RNNLM:
    """A seeded LM on ``device`` (init drawn on the CPU from ``--seed``)."""
    model = build_lm(args, ntokens)
    init_lm_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(device)


def _arch_dict(args, ntokens: int) -> dict:
    return {"rnn_type": args.model, "ntoken": ntokens, "ninp": args.emsize,
            "nhid": args.nhid, "nlayers": args.nlayers,
            "dropout": args.dropout, "tie_weights": args.tied}


def save_lm_ckpt(path: str, model: RNNLM, dictionary: Dictionary, args,
                 ntokens: int) -> None:
    save_lm_dir(path, "meta.json", "model.pt", model, dictionary.word2idx,
                _arch_dict(args, ntokens))


def load_lm_ckpt(path: str, device):
    """(model on ``device`` in eval mode, word2idx, arch)."""
    return load_lm_dir(path, "meta.json", "model.pt", device)


def _dictionary(word2idx: dict) -> Dictionary:
    dictionary = Dictionary()
    for w, _ in sorted(word2idx.items(), key=lambda kv: kv[1]):
        dictionary.add_word(w)
    return dictionary


def _snapshot(model: RNNLM) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _dropout_generator(args, device: torch.device) -> torch.Generator:
    return torch.Generator(device).manual_seed(args.seed)


def _train_epochs(model: RNNLM, train_data: np.ndarray,
                  val_data: Optional[np.ndarray], args,
                  device: torch.device) -> Optional[float]:
    """The plain epoch loop (lm/main.py:292-321): a fresh carry each epoch,
    full bptt windows (the ragged tail skipped), lr/4 on a validation
    plateau, patience 5. Leaves the best weights in ``model``; returns the
    best validation loss."""
    step = make_lm_sgd_step(model, args.clip)
    gen = _dropout_generator(args, device)
    lr = args.lr
    best_val, counter = None, 0
    best_state = _snapshot(model)
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        i, losses = 0, []
        carry = model.init_carry(train_data.shape[1])
        while i < len(train_data) - 1:
            data, target = get_batch(train_data, i, args.bptt)
            if data.shape[0] < args.bptt:
                break  # the reference trains on full windows
            loss, carry = step(data, target, lr, gen, carry)
            losses.append(loss)
            i += args.bptt
        total_loss = 0.0
        for v in (torch.stack(losses).tolist() if losses else []):
            total_loss += v
        val_loss = evaluate_lm(model, val_data, args.bptt) \
            if val_data is not None else 0.0
        log_print(
            "| end of epoch {:3d} | time: {:5.2f}s | train loss {:5.2f} | "
            "valid loss {:5.2f} | valid ppl {:8.2f}".format(
                epoch, time.time() - t0, total_loss / max(len(losses), 1),
                val_loss, math.exp(min(val_loss, 30))))
        if best_val is None or val_loss < best_val:
            best_val, counter = val_loss, 0
            best_state = _snapshot(model)
        else:
            lr /= 4.0
            counter += 1
        if counter == 5:
            break
    model.load_state_dict(best_state)
    return best_val


def main_main(argv=None):
    """lm/main.py: plain LM train/valid/test. Returns the saved path."""
    args = lm_parser("RNN/LSTM LM (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    setup_logging("lm_" + _log_name(args))
    corpus = Corpus(args.train_path, args.valid_path, args.test_path,
                    None, args.seed)
    ntokens = len(corpus.dictionary)
    model = _new_lm(args, ntokens, device)
    _train_epochs(model, batchify(corpus.train, args.batch_size),
                  corpus.valid, args, device)
    save_path = os.path.join(args.save, _log_name(args))
    save_lm_ckpt(save_path, model, corpus.dictionary, args, ntokens)
    if corpus.test is not None:
        idx2word = {v: k for k, v in corpus.dictionary.word2idx.items()}
        # the per-word probability dump of the test evaluation
        # (lm/main.py:199,217-250)
        os.makedirs("predictions", exist_ok=True)
        dump_path = os.path.join("predictions", "lm_" + _log_name(args))
        res = evaluate_lm_test(model, corpus.test, idx2word, args.bptt,
                               dump_path=dump_path)
        log_print("| End of training | test loss {:5.2f} | test ppl {:8.2f}"
                  .format(res["loss"], res["ppl"]))
        log_print(f"PER-WORD PROBS: {dump_path}")
    log_print(f"SAVED {save_path}")
    return save_path


def _load_chained_corpora(args):
    """One dictionary grown across the listed corpora in order; the last is
    the code-switched target (lm/main_meta_transfer.py:131-140)."""
    train_list = args.train_path_list or [args.train_path]
    valid_list = args.valid_path_list or ([args.valid_path]
                                          if args.valid_path else [])
    test_list = args.test_path_list or ([args.test_path]
                                        if args.test_path else [])
    corpora: List[Corpus] = []
    dictionary = None
    for i, tr in enumerate(train_list):
        c = Corpus(tr, valid_list[i] if i < len(valid_list) else None,
                   test_list[i] if i < len(test_list) else None,
                   dictionary, args.seed)
        dictionary = c.dictionary
        corpora.append(c)
    return corpora, dictionary


def _corpus_label(path: Optional[str], i: int) -> str:
    """A corpus tag from its train path (the reference hardcodes
    SEAME/CV/HKUST; these CLIs take arbitrary paths)."""
    if not path:
        return f"TASK{i}"
    parent = os.path.basename(os.path.dirname(os.path.normpath(path)))
    stem = os.path.splitext(os.path.basename(path))[0]
    return (parent or stem or f"task{i}").upper()


def _end_of_training_report(model: RNNLM, corpora, labels, bptt: int):
    """The test loss/ppl of every corpus with a test set, at the best
    weights (lm/main_joint.py:398-415)."""
    results = {}
    for label, c in zip(labels, corpora):
        if c.test is None:
            continue
        loss = evaluate_lm(model, c.test, bptt)
        log_print("{} {}| End of training | test loss {:5.2f} | test ppl "
                  "{:8.2f}{}".format(label, "=" * 89, loss,
                                     math.exp(min(loss, 30)), "=" * 89))
        results[label] = loss
    return results


class _LMValidator:
    """Valid/anneal/patience state of the iteration-based LM mains
    (lm/main_joint.py:340-378): log every --log-interval, validate every
    --valid-interval (and test the target), keep a copy of the best
    weights, lr/4 on a plateau, stop at patience 5. The step's losses stay
    on the device until a log or validation reads them."""

    def __init__(self, model: RNNLM, args, target_valid, target_test):
        self.model, self.args = model, args
        self.target_valid, self.target_test = target_valid, target_test
        self.lr = args.lr
        self.best_val, self.counter = None, 0
        self.best_state = _snapshot(model)
        self.window_loss = 0.0  # train loss since the last validation
        self.pending: List[torch.Tensor] = []
        self.t_log = time.time()

    def after_step(self, it: int, total: torch.Tensor,
                   tag: str = "word_loss") -> bool:
        """Returns True when training should stop (patience exhausted)."""
        args = self.args
        self.pending.append(total)
        log_interval = max(1, args.log_interval)
        valid_interval = max(1, args.valid_interval)
        if it % log_interval and it % valid_interval:
            return False
        values = torch.stack(self.pending).tolist()
        self.pending = []
        for v in values:
            self.window_loss += v
        if it % log_interval == 0:
            denom = it % valid_interval or valid_interval
            cur = self.window_loss / denom
            elapsed = time.time() - self.t_log
            log_print("| it {:5d} | lr {:02.2f} | ms/batch {:5.2f} | {} "
                      "{:5.2f} | avg ppl {:8.2f}".format(
                          it, self.lr, elapsed * 1000 / log_interval, tag,
                          cur, math.exp(min(cur, 30))))
            self.t_log = time.time()
        if it % valid_interval:
            return False
        if self.target_valid is not None:
            val_loss = evaluate_lm(self.model, self.target_valid, args.bptt)
        else:
            val_loss = values[-1]
        log_print("it {} | val loss {:5f} | ppl {:5f}".format(
            it, val_loss, math.exp(min(val_loss, 30))))
        if self.target_test is not None:  # lm/main_joint.py:360-361
            test_loss = evaluate_lm(self.model, self.target_test, args.bptt)
            log_print("it {} | test loss {:5f} | ppl {:5f}".format(
                it, test_loss, math.exp(min(test_loss, 30))))
        if self.best_val is None or val_loss < self.best_val:
            self.best_val, self.counter = val_loss, 0
            self.best_state = _snapshot(self.model)
        else:
            self.lr /= 4.0
            self.counter += 1
        self.window_loss = 0.0
        return self.counter == 5


def _train_iterations(args, device: torch.device, run_step: Callable,
                      tag: str, save_name: str):
    """The iteration loop shared by the joint and meta-transfer mains:
    chained corpora, a seeded LM on ``--device``, ``run_step(model, ds,
    it, lr, gen)`` -> the step's total loss for iterations 1..num_it
    (``--num-iterations``, else 100 x ``--epochs``) under the validator,
    then the best weights saved and tested on every corpus."""
    corpora, dictionary = _load_chained_corpora(args)
    ntokens = len(dictionary)
    ds = LMDataset([c.train for c in corpora], args.bptt, args.batch_size)
    model = _new_lm(args, ntokens, device)
    target_valid = next(
        (c.valid for c in reversed(corpora) if c.valid is not None), None)
    target_test = next(
        (c.test for c in reversed(corpora) if c.test is not None), None)
    step = run_step(model, joint_ratios(len(corpora), args.ratio))
    gen = _dropout_generator(args, device)
    num_it = args.num_iterations or args.epochs * 100
    val = _LMValidator(model, args, target_valid, target_test)
    for it in range(1, num_it + 1):
        if val.after_step(it, step(ds, it, val.lr, gen), tag=tag):
            break
    model.load_state_dict(val.best_state)
    save_path = os.path.join(args.save, save_name)
    save_lm_ckpt(save_path, model, dictionary, args, ntokens)
    labels = [_corpus_label(p, i) for i, p in
              enumerate(args.train_path_list or [args.train_path])]
    _end_of_training_report(model, corpora, labels, args.bptt)
    log_print(f"SAVED {save_path}")
    return save_path


def _task_windows(ds: LMDataset, it: int):
    """(datas [K, T, B], targets [K, T*B]): every task's training window of
    iteration ``it``."""
    samples = [ds.sample(i, it - 1) for i in range(len(ds.task_list))]
    return (np.stack([s[0] for s in samples]),
            np.stack([s[1] for s in samples]))


def main_joint_main(argv=None):
    """lm/main_joint.py: ratio-weighted multi-corpus training. Returns the
    saved path."""
    args = lm_parser("Joint LM (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    extra = f"_ratio{args.ratio}"
    setup_logging("lm_joint_" + _log_name(args, extra))

    def run_step(model, ratios):
        step = make_lm_joint_step(model, args.clip, ratios)
        return lambda ds, it, lr, gen: step(*_task_windows(ds, it), lr,
                                            gen)[0]

    return _train_iterations(args, device, run_step, "word_loss",
                             "joint_" + _log_name(args, extra))


def main_meta_transfer_main(argv=None):
    """lm/main_meta_transfer.py: meta-transfer towards the last corpus,
    first order or ``--second-order``. Returns the saved path."""
    args = lm_parser("Meta-transfer LM (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    extra = f"_meta_lr_factor{args.meta_lr_factor}_ratio{args.ratio}"
    setup_logging("lm_meta_" + _log_name(args, extra))

    def run_step(model, ratios):
        step = make_lm_meta_step(model, args.clip, ratios,
                                 args.meta_lr_factor,
                                 second_order=args.second_order)

        def run(ds, it, lr, gen):
            # the query: the last task's valid window
            # (lm/main_meta_transfer.py:302)
            _, _, q_data, q_target = ds.sample(-1, it - 1)
            return step(*_task_windows(ds, it), q_data, q_target, lr, gen)[0]
        return run

    return _train_iterations(args, device, run_step, "meta loss",
                             "meta_" + _log_name(args, extra))


def finetune_main(argv=None):
    """lm/finetune.py: epoch training of the ``--load`` LM on one corpus,
    its dictionary kept (and grown by the corpus's new words, which the
    LM's vocabulary must cover). Returns the saved path."""
    args = lm_parser("Finetune LM (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    if not args.load:
        raise ValueError("--load is required for finetune")
    setup_logging("lm_finetune_" + _log_name(args))
    model, word2idx, arch = load_lm_ckpt(args.load, device)
    dictionary = _dictionary(word2idx)
    corpus = Corpus(args.train_path, args.valid_path, args.test_path,
                    dictionary, args.seed)
    unseen = len(dictionary) - arch["ntoken"]
    if unseen > 0:
        raise ValueError(f"the finetune corpus has {unseen} words outside "
                         f"the LM's {arch['ntoken']}")
    _train_epochs(model, batchify(corpus.train, args.batch_size),
                  corpus.valid, args, device)
    save_path = os.path.join(args.save, "finetune_" + _log_name(args))
    save_lm_ckpt(save_path, model, dictionary, args, arch["ntoken"])
    log_print(f"SAVED {save_path}")
    return save_path


def test_main(argv=None):
    """lm/test.py: perplexity + code-switch transition breakdown of the
    ``--load`` checkpoint on ``--test_path`` (else ``--train_path``).
    Returns the result dict it logs as JSON."""
    args = lm_parser("Test LM (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    if not args.load:
        raise ValueError("--load is required for test")
    setup_logging("lm_test_" + _log_name(args))
    model, word2idx, _ = load_lm_ckpt(args.load, device)
    dictionary = _dictionary(word2idx)
    corpus = Corpus(args.test_path or args.train_path, None, None,
                    dictionary, args.seed)
    idx2word = {v: k for k, v in word2idx.items()}
    os.makedirs("predictions", exist_ok=True)
    dump_path = os.path.join("predictions", "lm_test_" + _log_name(args))
    res = evaluate_lm_test(model, corpus.train, idx2word, args.bptt,
                           dump_path=dump_path)
    log_print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in res.items()}, ensure_ascii=False))
    log_print(f"PER-WORD PROBS: {dump_path}")
    return res


def convert_main(argv=None):
    """lm/convert.py: re-save the ``--load`` checkpoint as a fusion
    directory at ``--save``. Returns its path."""
    args = lm_parser("Convert LM (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    if not args.load:
        raise ValueError("--load is required for convert")
    model, word2idx, arch = load_lm_ckpt(args.load, device)
    save_lm_fusion(args.save, model, word2idx, arch)
    print(f"CONVERTED -> {args.save}")
    return args.save
