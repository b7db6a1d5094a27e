"""Batched greedy decoding with a KV cache (port of
mtl_tpu/decode/greedy.py; reference Decoder.greedy_search,
modules/decoder.py:131-184).

Start token, at most ``max_steps`` steps, argmax next token; the host cuts
each row's string at the first EOS. Like the reference's search, no
decoder-encoder mask is used (padded encoder frames are attended). The loop
runs on the device and stops once every row has emitted EOS: the all-done
test is its only host sync per step. Unwritten slots hold EOS.

Spans (``utils/trace.py``): ``greedy.loop`` the whole loop, ``greedy.step``
one step (its self time dispatches the step), ``greedy.done_sync`` the
all-done test inside it (the host's wait for the step).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..data.vocab import EOS_ID, Vocab
from ..models.transformer import ASRTransformer
from ..utils.trace import span


@torch.no_grad()
def greedy_decode_ids(model: ASRTransformer, features: torch.Tensor,
                      input_lengths: torch.Tensor, max_steps: int = 300,
                      start_token: int = 1) -> torch.Tensor:
    """Returns decoded token ids [B, max_steps] (EOS handling on host)."""
    _, enc_kvs = model.prepare_decode(features, input_lengths)
    return greedy_loop(model, enc_kvs, features.shape[0], features.device,
                       max_steps, start_token)


@torch.no_grad()
def greedy_loop(model: ASRTransformer, enc_kvs, b: int,
                device: torch.device, max_steps: int = 300,
                start_token: int = 1) -> torch.Tensor:
    """The KV-cache decode loop of ``greedy_decode_ids``, on the decoder
    layers' precomputed cross-attention K/V."""
    with span("greedy.loop"):
        caches = model.init_cache(b, max_steps + 1, device)
        y_t = torch.full((b,), start_token, dtype=torch.long, device=device)
        ys = torch.full((b, max_steps), EOS_ID, dtype=torch.long,
                        device=device)
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        for t in range(max_steps):
            with span("greedy.step"):
                logits, caches = model.decode_step(y_t, t, enc_kvs, caches)
                y_t = torch.argmax(logits, dim=-1)
                ys[:, t] = y_t
                done |= y_t == EOS_ID
                with span("greedy.done_sync"):
                    stop = bool(done.all())
            if stop:
                break
        return ys


def ids_to_strings(ids, vocab: Vocab) -> List[str]:
    """Cut each row at the first EOS and join labels (greedy_search
    string-building parity, modules/decoder.py:175-184)."""
    out = []
    for row in np.asarray(ids):
        chars = []
        for i in row:
            if int(i) == EOS_ID:
                break
            chars.append(vocab.id2label[int(i)])
        out.append("".join(chars))
    return out


def greedy_search(model: ASRTransformer, features, input_lengths,
                  vocab: Vocab, max_steps: int = 300,
                  start_token: int = 1) -> List[str]:
    ids = greedy_decode_ids(model, features, input_lengths, max_steps,
                            start_token)
    return ids_to_strings(ids.cpu(), vocab)
