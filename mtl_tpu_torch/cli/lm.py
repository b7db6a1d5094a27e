"""LM CLI entry points of the port (mtl_tpu/cli/lm.py parity; reference
lm/test.py and lm/convert.py).

* ``test_main`` — lm/test.py: perplexity plus the code-switch transition
  breakdown of a saved LM on a corpus, and the per-word probability dump
  (``predictions/lm_test_<name>``); console script ``mtl-torch-lm-test``;
* ``convert_main`` — lm/convert.py: a saved LM re-saved as a fusion
  directory for ``test_main --lm-rescoring --lm-path``; console script
  ``mtl-torch-lm-convert``.

Flags are the reference's (``lm_parser``) plus ``--device`` (default
``cuda``, which raises without a card). An LM checkpoint is a directory of
``meta.json`` ({arch, word2idx}) and ``model.pt`` (the f32 state_dict).
LM training (lm/main.py, main_joint.py, main_meta_transfer.py,
finetune.py) is not ported yet: its entry points raise.
"""

from __future__ import annotations

import argparse
import json
import os

from ..lm.data import Corpus, Dictionary
from ..lm.fusion import load_lm_dir, save_lm_dir, save_lm_fusion
from ..lm.model import RNNLM
from ..lm.train import evaluate_lm_test
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
    return RNNLM(rnn_type=args.model, ntoken=ntokens, ninp=args.emsize,
                 nhid=args.nhid, nlayers=args.nlayers, dropout=args.dropout,
                 tie_weights=args.tied)


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


def _not_ported(name: str):
    def main(argv=None):
        raise ValueError(f"{name} (LM training) is not ported yet")
    main.__doc__ = f"{name}: LM training, not ported yet (raises)."
    return main


main_main = _not_ported("lm/main.py")
main_joint_main = _not_ported("lm/main_joint.py")
main_meta_transfer_main = _not_ported("lm/main_meta_transfer.py")
finetune_main = _not_ported("lm/finetune.py")


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
    dictionary = Dictionary()
    for w, _ in sorted(word2idx.items(), key=lambda kv: kv[1]):
        dictionary.add_word(w)
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
