"""The training loops on the host (port of the ``TransientTrainer`` and
``JointTrainer`` paths of mtl_tpu/train/trainer.py; reference
trainer/asr/transient_trainer.py and joint_trainer.py).

Per iteration: the next batch from a double-buffer thread, one step on the
device (train/steps.py: the first-order meta step, or the joint step), the
train CER of the (support) hypotheses on the host, the reference's log
lines letter for letter; every ``--evaluate-every`` iterations an
evaluation of the valid sets, a checkpoint when the iteration is also a
multiple of ``--save-every``, the best model by the early-stop criterion,
and the early stop itself. The two trainers differ only in their
optimizer, step, batch and logged learning rate.

The batch stream is the JAX package's: a trainer that builds its state
itself first draws one batch (the JAX trainer's example batch for
``init_train_state``), and only then starts the prefetch thread, so both
packages train on the same draws for one seed. ``--continue-from``
restores the weights and, when the checkpoint's optimizer state has the
structure of this trainer's optimizer, the step and that state too; else
the weights alone, as the JAX trainers fall back to params. Mesh axes,
several prefetch workers, the device CER, the discriminator heads,
profiling and remat are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.dataset import SpectrogramDataset
from ..data.vocab import Vocab, post_process
from ..models.transformer import init_weights
from ..utils.checkpoint import load_checkpoint, load_train_state, \
    save_checkpoint
from ..utils.logger import log_print
from ..utils.metrics import calculate_cer_batch
from ..utils.params import compute_num_params
from .optim import (make_joint_optimizer, make_meta_optimizers,
                    restore_opt_state)
from .steps import (TrainState, batch_to_device, init_train_state,
                    make_eval_step, make_joint_step, make_meta_step)


def batch_cer(hyp_ids, gold_ids, vocab: Vocab):
    """(total_cer, total_char) from id arrays, reference post-processing
    (forward_one_batch, transient_trainer.py:55-64)."""
    hyp_ids = np.asarray(hyp_ids).reshape(-1, np.asarray(hyp_ids).shape[-1])
    gold_ids = np.asarray(gold_ids).reshape(-1, np.asarray(gold_ids).shape[-1])
    pairs = []
    total_char = 0
    for h, g in zip(hyp_ids, gold_ids):
        hs = post_process(vocab.decode_ids(h), vocab.special_token_list)
        gs = post_process(vocab.decode_ids(g), vocab.special_token_list)
        pairs.append((hs.replace(" ", ""), gs.replace(" ", "")))
        total_char += len(gs.replace(" ", ""))
    dists = calculate_cer_batch(pairs)
    return int(sum(dists)), int(total_char)


class Prefetcher:
    """Double-buffered background fetch (transient_trainer.py:127-139).

    A fetch exception is captured in the worker thread and re-raised from
    ``get()`` (after re-arming the next fetch), never replayed as stale
    data. ``stop()`` waits for the fetch in flight and starts no other."""

    def __init__(self, fetch_fn):
        self.fetch_fn = fetch_fn
        self._result = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.start()

    def start(self):
        def run():
            try:
                self._result = self.fetch_fn()
                self._error = None
            except BaseException as e:  # re-raised on the consumer thread
                self._result = None
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def get(self):
        self._thread.join()
        out, err = self._result, self._error
        self.start()
        if err is not None:
            raise err
        return out

    def stop(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class EarlyStopper:
    """`criterion,patience` parsing + best-value tracking
    (transient_trainer.py:93,337-360)."""

    def __init__(self, early_stop: str):
        crit, val = early_stop.split(",")
        self.criterion = crit
        self.patience = int(val)
        self.best = 1e9
        self.count = 0

    def update(self, avg_loss: float, avg_cer: float) -> bool:
        """Returns True if this is a new best."""
        value = avg_cer if self.criterion == "cer" else avg_loss
        if value < self.best:
            self.best = value
            self.count = 0
            return True
        self.count += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.count >= self.patience


def check_ported(cfg: Config) -> None:
    """Raises for the training options the port does not have yet."""
    missing = [flag for flag, on in (
        ("--mesh-task/--mesh-data/--mesh-model > 1",
         max(cfg.mesh.task, cfg.mesh.data, cfg.mesh.model) > 1),
        ("--prefetch-workers > 1", cfg.train.prefetch_workers > 1),
        ("--device-cer", cfg.train.device_cer),
        ("--adversarial/--multitask",
         cfg.train.adversarial or cfg.train.multitask),
        ("--profile-dir", bool(cfg.train.profile_dir)),
        ("--second-order", cfg.train.second_order),
        ("--remat/--remat-conv", cfg.model.remat or cfg.model.remat_conv),
    ) if on]
    if missing:
        raise ValueError(f"{', '.join(missing)}: not ported yet")


class TrainerBase:
    # reference-parity in-loop recovery (transient_trainer.py:366-377)
    # retries forever; consecutive failures are capped so that a persistent
    # error cannot spin a run silently
    MAX_CONSECUTIVE_FAILURES = 20

    def __init__(self, model: torch.nn.Module, cfg: Config, vocab: Vocab,
                 device: torch.device):
        check_ported(cfg)
        self.model = model
        self.cfg = cfg
        self.vocab = vocab
        self.device = device
        self.eval_step = make_eval_step(model, cfg)
        if (cfg.train.save_every % max(cfg.train.evaluate_every, 1) != 0
                and cfg.train.evaluate_every % max(cfg.train.save_every, 1)
                != 0):
            # reference parity: periodic saves fire only on iterations where
            # BOTH (it+1) % evaluate_every == 0 and (it+1) % save_every == 0
            # (transient_trainer.py:311,333)
            log_print(
                "WARNING: --save-every {} is not a multiple of "
                "--evaluate-every {}; periodic checkpoints only happen on "
                "iterations divisible by both".format(
                    cfg.train.save_every, cfg.train.evaluate_every
                )
            )

    def evaluate(self, valid_sets: Sequence[SpectrogramDataset], it: int):
        """No-grad eval over the valid sets (transient_trainer.py:280-331),
        at the model's current parameters. The final ragged batch is padded
        with duplicate rows; loss and CER count its ``num_valid`` real rows
        only."""
        final_losses, final_cers = [], []
        for ind, ds in enumerate(valid_sets):
            total_loss, total_cer, total_char, n_batches = 0.0, 0, 0, 0
            for batch, num_valid in ds.iter_batches(
                    self.cfg.train.k_valid, shuffle=False,
                    with_valid_count=True):
                _, aux = self.eval_step(batch_to_device(batch, self.device))
                row_loss = aux["row_loss"].cpu().numpy()[:num_valid]
                row_tok = aux["row_tokens"].cpu().numpy()[:num_valid]
                cer, nchar = batch_cer(aux["hyp"].cpu().numpy()[:num_valid],
                                       aux["gold"].cpu().numpy()[:num_valid],
                                       self.vocab)
                total_loss += float(row_loss.sum()) / max(float(row_tok.sum()),
                                                          1.0)
                total_cer += cer
                total_char += max(nchar, 1) if nchar else 1
                n_batches += 1
            if n_batches == 0:
                continue
            vloss = total_loss / n_batches
            vcer = total_cer * 100.0 / max(total_char, 1)
            final_losses.append(vloss)
            final_cers.append(vcer)
            log_print(
                "(Iteration {}) VALID SET {} LOSS:{:.4f} CER:{:.2f}%".format(
                    it + 1, ind, vloss, vcer
                )
            )
        avg_loss = sum(final_losses) / max(len(final_losses), 1)
        avg_cer = sum(final_cers) / max(len(final_cers), 1)
        log_print(
            "(Iteration {}) AVG VALID LOSS:{:.4f} AVG CER:{:.2f}%".format(
                it + 1, avg_loss, avg_cer
            )
        )
        return avg_loss, avg_cer, final_losses, final_cers


    # -- the loop shared by the trainers; the subclasses' hooks: ---------
    # make_optimizer(), make_step(opt), fetch_fn(dataset) (draws one batch),
    # run_step(step, state, batch, generator) -> (state, loss, hyp, gold),
    # and the learning rate the TRAIN line prints, ``logged_lr``

    def _build_state(self, opt) -> TrainState:
        """Seeded init, or the checkpoint of ``--continue-from``: its
        weights, and its step and optimizer state when that has the
        structure of ``opt``'s (mtl_tpu/train/trainer.py:603-626)."""
        cfg = self.cfg
        init_weights(self.model, torch.Generator().manual_seed(cfg.train.seed))
        state = init_train_state(self.model, opt)
        if cfg.continue_from:
            _, _, state_dict, _, _ = load_checkpoint(cfg.continue_from)
            self.model.load_state_dict(state_dict)
            saved = load_train_state(cfg.continue_from)
            if saved is not None:
                step = saved.pop("step")
                if restore_opt_state(state.opt_state, saved):
                    state.step = step
            log_print(f"RESTORED STATE from {cfg.continue_from}")
        return state

    def train(self, train_dataset: SpectrogramDataset,
              valid_sets: Sequence[SpectrogramDataset], start_it: int = 0,
              num_it: int = 1000, state: Optional[TrainState] = None,
              last_metrics: Optional[dict] = None) -> TrainState:
        opt = self.make_optimizer()
        step_fn = self.make_step(opt)
        fetch = self.fetch_fn(train_dataset)
        if state is None:
            fetch()  # the JAX trainer's init batch: keeps the stream aligned
            state = self._build_state(opt)
        generator = torch.Generator(self.device).manual_seed(
            self.cfg.train.seed)

        # the double buffer starts after the initial draw: two threads
        # drawing from the dataset's RandomState would reorder the stream
        prefetch = Prefetcher(fetch)
        try:
            return self._loop(state, step_fn, prefetch, generator,
                              valid_sets, start_it, num_it, last_metrics)
        finally:
            prefetch.stop()

    def _loop(self, state, step_fn, prefetch, generator, valid_sets,
              start_it, num_it, last_metrics) -> TrainState:
        cfg = self.cfg
        stopper = EarlyStopper(cfg.train.early_stop)
        history: List[dict] = (last_metrics or {}).get("history", [])
        window = 100
        last_sum_loss, last_sum_cer, last_sum_char = (
            deque(maxlen=window), deque(maxlen=window), deque(maxlen=window)
        )
        total_time = 0.0
        failures = 0
        it = start_it
        while it < num_it:
            # in-loop fault recovery (transient_trainer.py:364-377,
            # joint_trainer.py:391-405): a data error drops the batch,
            # refetches and keeps `it`
            try:
                batch = prefetch.get()
            except Exception as e:
                failures += 1
                log_print(f"Error: {e!r}, fetching new data...")
                if failures >= self.MAX_CONSECUTIVE_FAILURES:
                    raise
                continue
            failures = 0
            start_time = time.time()
            state, loss, hyp, gold = self.run_step(step_fn, state, batch,
                                                   generator)
            loss = float(loss)
            if (it + 1) % max(cfg.train.train_cer_every, 1) == 0:
                cer, nchar = batch_cer(hyp.cpu().numpy(), gold.cpu().numpy(),
                                       self.vocab)
            else:
                cer, nchar = 0, 1
            total_time += time.time() - start_time
            last_sum_loss.append(loss)
            last_sum_cer.append(cer)
            last_sum_char.append(max(nchar, 1))

            log_print(
                "(Iteration {}) TRAIN LOSS:{:.4f} CER:{:.2f}% "
                "LR:{:.7f} TOTAL TIME:{:.7f}".format(
                    it + 1, loss, cer * 100.0 / max(nchar, 1),
                    self.logged_lr, total_time
                )
            )
            if (it + 1) % 1000 == 0:
                log_print(
                    "(Summary Iteration {} | MA {}) TRAIN LOSS:{:.4f} "
                    "CER:{:.2f}%".format(
                        it + 1, window,
                        sum(last_sum_loss) / len(last_sum_loss),
                        sum(last_sum_cer) * 100.0 / max(sum(last_sum_char), 1),
                    )
                )

            if (it + 1) % cfg.train.evaluate_every == 0:
                avg_loss, avg_cer, vlosses, vcers = self.evaluate(valid_sets,
                                                                  it)
                metrics = {
                    "avg_valid_loss": avg_loss,
                    "avg_valid_cer": avg_cer,
                    "valid_loss": vlosses,
                    "valid_cer": vcers,
                    "history": history,
                }
                history.append(dict(metrics, history=None))
                weights = self.model.state_dict()
                if (it + 1) % cfg.train.save_every == 0:
                    save_checkpoint(cfg, self.vocab, weights, it + 1, metrics,
                                    opt_state=state.opt_state)
                if stopper.update(avg_loss, avg_cer):
                    save_checkpoint(cfg, self.vocab, weights, it + 1, metrics,
                                    best_model=True,
                                    opt_state=state.opt_state)
                else:
                    log_print(f"count_stop: {stopper.count}")
                if stopper.should_stop:
                    log_print("EARLY STOP")
                    break
            it += 1
        return state


class TransientTrainer(TrainerBase):
    """Meta-transfer trainer (transient_trainer.py:79-377): the first-order
    meta step, outer Adam at ``meta_lr``."""

    def _build_state(self, opt) -> TrainState:
        state = super()._build_state(opt)
        log_print("Parameters: {}(trainable), {}(non-trainable)".format(
            *compute_num_params(self.model)))
        return state

    @property
    def logged_lr(self) -> float:
        return self.cfg.train.meta_lr

    def make_optimizer(self):
        return make_meta_optimizers(self.cfg)[1]

    def make_step(self, opt):
        return make_meta_step(self.model, self.cfg, opt)

    def fetch_fn(self, train_dataset: SpectrogramDataset):
        cfg = self.cfg
        return lambda: train_dataset.sample_meta_batch(cfg.train.k_train,
                                                       cfg.train.k_valid)

    def run_step(self, step_fn, state, batch, generator):
        support, query = (batch_to_device(b, self.device) for b in batch)
        state, m = step_fn(state, support, query, generator)
        return state, m["outer_loss"], m["support_hyp"], m["support_gold"]


class JointTrainer(TrainerBase):
    """Iteration-based multi-task trainer (joint_trainer.py), also the
    finetune path (finetune.py:199-200): the joint step, Adam at ``lr`` or
    SGD with nesterov momentum (``--opt_name sgd``)."""

    @property
    def logged_lr(self) -> float:
        return self.cfg.train.lr

    def make_optimizer(self):
        return make_joint_optimizer(self.cfg)

    def make_step(self, opt):
        return make_joint_step(self.model, self.cfg, opt)

    def fetch_fn(self, train_dataset: SpectrogramDataset):
        cfg = self.cfg
        # the JAX trainer's draw: every task's k_train support batch and a
        # query of one utterance, which it drops
        return lambda: train_dataset.sample_meta_batch(cfg.train.k_train,
                                                       1)[0]

    def run_step(self, step_fn, state, batch, generator):
        state, loss, aux = step_fn(state, batch_to_device(batch, self.device),
                                   generator)
        return state, loss, aux["hyp"], aux["gold"]
