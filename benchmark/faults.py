"""Faults planted in the program underneath a run, for the check's
controls: each must make ``correct`` come out false.

* ``state_unchanged``: the outer optimizer's update returns its state and
  the weights as they were;
* ``half_batch``: every training batch loses half its rows, and the loss
  is the mean over the rest;
* ``token_altered``: the greedy loop serves one token other than it
  decoded.

A one-card cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def state_unchanged():
    from mtl_tpu_torch.train import optim

    real = optim.Adam.update
    optim.Adam.update = lambda self, grads, state, params: state
    try:
        yield
    finally:
        optim.Adam.update = real


@contextlib.contextmanager
def half_batch():
    from mtl_tpu_torch.train import trainer

    real = trainer.TransientTrainer.run_step

    def run_step(self, step_fn, state, batch, generator, beta):
        support, query = batch
        h = support["targets"].shape[1] // 2
        cut = ({k: v[:, :h] for k, v in support.items()},
               {k: v[:h] for k, v in query.items()})
        return real(self, step_fn, state, cut, generator, beta)

    trainer.TransientTrainer.run_step = run_step
    try:
        yield
    finally:
        trainer.TransientTrainer.run_step = real


@contextlib.contextmanager
def token_altered():
    from mtl_tpu_torch.decode import greedy

    real = greedy.greedy_loop

    def loop(model, enc_kvs, b, device, max_steps=300, start_token=1):
        ids = real(model, enc_kvs, b, device, max_steps, start_token)
        t = ids.shape[1] // 2
        ids[0, t] = 4 + (int(ids[0, t]) - 3) % (
            model.decoder.output_linear.weight.shape[0] - 4)
        return ids

    greedy.greedy_loop = loop
    try:
        yield
    finally:
        greedy.greedy_loop = real


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
