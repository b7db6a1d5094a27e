"""The training loops on the host (port of the ``TransientTrainer``,
``MetaTrainer``, ``JointTrainer`` and ``EpochTrainer`` paths of
mtl_tpu/train/trainer.py; reference trainer/asr/transient_trainer.py,
meta_trainer.py, joint_trainer.py and trainer.py).

Per iteration: the next batch from a double-buffer thread (or, with
``--prefetch-workers N > 1``, from N workers that draw future iterations
ahead, each from its own per-iteration ``RandomState``), one step on the
device (train/steps.py: the meta step, first or second order, with the
shared or the per-task query, or the joint step, each optionally with the
discriminator head of train/steps_disc.py), the train CER of the (support)
hypotheses on the host (with ``--device-cer``, two scalars the step
computed on the device, except under a discriminator head, as in the JAX
package), the reference's log lines letter for letter; with
``--profile-dir`` a torch.profiler trace of iterations start+4 to start+8,
which carries the main thread's spans (``utils/trace.py``:
``train.iteration``, ``data.wait``, ``train.to_device``, the meta step's
phases, ``train.cer``);
every ``--evaluate-every`` iterations an evaluation of the valid sets, a
checkpoint when the iteration is also a multiple of ``--save-every``, the
best model by the early-stop criterion, and the early stop itself. The
iteration trainers differ only in their optimizer, step, batch and logged
learning rate. The epoch trainer runs its own epochs over shuffled batches
of one task (K = 1 joint steps, Noam Adam) on the same helpers: state,
evaluation, checkpoints, early stop.

The batch stream is the JAX package's: a trainer that builds its state
itself first draws one batch (the JAX trainer's example batch for
``init_train_state``), and only then starts the prefetch thread, so both
packages train on the same draws for one seed. ``--continue-from``
restores the weights and, when the checkpoint's optimizer state has the
structure of this trainer's optimizer (and, with a discriminator, the
checkpoint holds one whose state fits too), the step and those states;
else the weights alone, as the JAX trainers fall back to params. The epoch
trainer restores strictly, as the JAX one does. ``meta_evaluate`` is
meta-test: one inner step on a support draw, then evaluation at the
adapted weights; it stays first order under ``--second-order``, as in the
JAX package.

On a mesh (``--mesh-task`` / ``--mesh-data``, ``parallel/``), every rank
runs the loop: it draws the same batch from the same seeded stream and
keeps its ``[K / task, B / data]`` slice, and the steps reduce over the
ranks (train/steps.py), so every rank holds the same weights after each
step. Rank 0 alone prints, evaluates, profiles and writes checkpoints, as
the JAX package evaluates replicated params outside the mesh
(mtl_tpu/train/trainer.py:229-245); every rank restores a checkpoint,
which holds full tensors, and ``replicate_state`` then makes rank 0's
weights everyone's. A decision that ends or skips an iteration is taken
for all ranks at once: the early stop is rank 0's, broadcast; a batch that
fails to load on any rank is dropped on every rank. Each rank draws its
dropout from its own generator, seeded from the run's seed and its place
in the (task, data) plane.

With ``--mesh-model M`` (tensor parallel, ``parallel/tp.py``; not with a
discriminator head, which keeps the model replicated over the axis as the
JAX package does) the state is built and replicated as above, the mesh's
refusals are raised, and then each rank keeps its slice of the split
parameters and of their optimizer moments. The M ranks of one (task,
data) place run the same step on the same batch slice with the same
dropout generator, so a split activation's masks are those of the M = 1
mesh. Evaluation, the train CER and MAML's meta-test run the sharded
forward on the M ranks of rank 0's place; checkpoints hold full tensors,
gathered there and written by rank 0, so that one process serves or
resumes them, and a resume on a mesh slices them again.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import SpectrogramDataset
from ..data.vocab import Vocab, post_process
from ..models.discriminator import Discriminator
from ..models.transformer import init_weights
from ..parallel import comm, tp
from ..parallel.mesh import (replicate_state, shard_batch,
                             shard_batch_prefix, validate_mesh_divisibility)
from ..utils.checkpoint import load_checkpoint, load_train_state, \
    save_checkpoint
from ..utils.logger import log_print
from ..utils.metrics import calculate_cer_batch
from ..utils.params import compute_num_params
from ..utils.precision import strict_f32
from ..utils.trace import span
from .graphs import GraphedMetaStep, graphs_engage
from .optim import (make_epoch_optimizer, make_joint_optimizer,
                    make_meta_optimizers, opt_state_fits, restore_opt_state)
from .steps import (TrainState, _clip_tree, batch_to_device,
                    init_train_state, make_eval_step, make_forward_fn,
                    make_joint_step, make_meta_step, tp_split)
from .steps_disc import (init_disc_state, make_joint_step_disc,
                         make_meta_step_disc)


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
        with span("data.wait"):
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


class MultiWorkerPrefetcher:
    """Ordered N-worker prefetch (mtl_tpu/train/trainer.py:102-141):
    ``fetch_at(i)`` is a pure function of the iteration index (the
    trainers draw iteration i from ``RandomState((seed * 1_000_003 + i) %
    2**32)``), so workers compute future iterations concurrently and
    ``get()`` hands them out in order: the stream is the same for any
    worker count above 1. A worker's exception re-raises from ``get()``
    for its iteration only. ``stop()`` cancels the fetches not started and
    waits for those running, so no fetch outlives the loop."""

    def __init__(self, fetch_at, num_workers: int, start: int = 0):
        self.fetch_at = fetch_at
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers),
                                       thread_name_prefix="prefetch")
        self.depth = max(2, 2 * num_workers)
        self._futures: dict = {}
        self._next = start
        self._head = start
        for _ in range(self.depth):
            self._submit()

    def _submit(self):
        self._futures[self._next] = self.pool.submit(self.fetch_at,
                                                     self._next)
        self._next += 1

    def get(self):
        fut = self._futures.pop(self._head)
        self._head += 1
        self._submit()
        with span("data.wait"):
            return fut.result()

    def stop(self):
        self.pool.shutdown(wait=True, cancel_futures=True)
        self._futures.clear()


def iteration_rng(seed: int, i: int) -> np.random.RandomState:
    """The RandomState of iteration ``i``'s draw under several prefetch
    workers (mtl_tpu/train/trainer.py:376-377)."""
    return np.random.RandomState((seed * 1_000_003 + i) % (2 ** 32))


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


def check_mesh(cfg: Config, shape, num_tasks: int, kind: str) -> None:
    """The JAX trainers' refusals of a mesh ``shape`` (task, data, ...):
    ``kind`` "meta" (a meta trainer without a discriminator head,
    mtl_tpu/train/trainer.py:303-307, 363-370), "joint" (a joint trainer,
    or a meta trainer with the head, :628-637) or "epoch" (:783-793)."""
    task, data = shape[0], shape[1]
    if kind == "epoch":
        if task > 1:
            raise ValueError(
                "--mesh-task > 1 is a meta/joint-trainer axis; the epoch "
                "trainer shards over --mesh-data only"
            )
        if cfg.data.batch_size % data:
            raise ValueError(
                f"--mesh-data {data} must divide "
                f"--batch-size ({cfg.data.batch_size})"
            )
        return
    if kind == "meta" and cfg.train.scan_tasks and task > 1:
        raise ValueError(
            "--scan-tasks serializes the task axis; it cannot be "
            "combined with --mesh-task > 1 (tasks are sharded there)")
    validate_mesh_divisibility(shape, num_tasks, cfg.train.k_train,
                               cfg.train.k_valid)


def rank_generator(device: torch.device, seed: int, mesh=None
                   ) -> torch.Generator:
    """The dropout generator of a run: seeded from the run's seed, and on
    a mesh from the rank's place in the (task, data) plane too (rank 0
    keeps the run's seed; the ranks of one ``model`` group draw alike)."""
    place = 0 if mesh is None else mesh.plane.index
    return torch.Generator(device).manual_seed(
        (seed + 1_000_003 * place) % (2 ** 63))


class TrainerBase:
    # reference-parity in-loop recovery (transient_trainer.py:366-377)
    # retries forever; consecutive failures are capped so that a persistent
    # error cannot spin a run silently
    MAX_CONSECUTIVE_FAILURES = 20

    def __init__(self, model: torch.nn.Module, cfg: Config, vocab: Vocab,
                 device: torch.device,
                 discriminator: Optional[Discriminator] = None, mesh=None):
        """``discriminator`` (on ``device``) turns on the adversarial or
        multitask head, as ``cfg.train.adversarial`` says; ``mesh``
        (``parallel/mesh.py``, None: one process) is this rank's."""
        self.model = model
        self.discriminator = discriminator
        self.cfg = cfg
        self.vocab = vocab
        self.device = device
        self.mesh = mesh
        self.is_root = mesh is None or mesh.is_root
        # tensor parallel: the model's split over the mesh's model axis
        self.sharded = (mesh is not None and mesh.model.size > 1
                        and discriminator is None)
        # the ranks that evaluate and write checkpoints: rank 0, and under
        # tensor parallel the other ranks of its model group
        self.evaluates = mesh is None or (
            mesh.plane.index == 0 if self.sharded else mesh.is_root)
        self.space_id = vocab.label2id.get(" ")
        self.eval_step = make_eval_step(model, cfg)
        if mesh is not None:
            where = (f"{min(mesh.size, torch.cuda.device_count())} card(s)"
                     if device.type == "cuda" else "the CPU")
            log_print(
                "MESH: task={task} data={data} model={model} over {n} {plat} "
                "device(s) (one process per rank over {backend} on "
                "{where})".format(**mesh.shape, n=mesh.size, plat=device.type,
                                  backend=mesh.backend, where=where))
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

    def evaluate(self, valid_sets: Sequence[SpectrogramDataset], it: int,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """No-grad eval over the valid sets (transient_trainer.py:280-331),
        at the model's current parameters or at ``params``. The final
        ragged batch is padded with duplicate rows; loss and CER count its
        ``num_valid`` real rows only."""
        final_losses, final_cers = [], []
        for ind, ds in enumerate(valid_sets):
            total_loss, total_cer, total_char, n_batches = 0.0, 0, 0, 0
            for batch, num_valid in ds.iter_batches(
                    self.cfg.train.k_valid, shuffle=False,
                    with_valid_count=True):
                _, aux = self.eval_step(batch_to_device(batch, self.device),
                                        params)
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

    def _train_cer(self, hyp, gold, metrics, n: int) -> Tuple[int, int]:
        """(edit distance, gold characters) of a step's train CER: the
        step's device scalars under ``--device-cer`` when it returned them
        (a discriminator step does not), else the host CER every
        ``--train-cer-every`` steps (the ``n``-th counted from 0), else
        (0, 1) (mtl_tpu/train/trainer.py:441-446)."""
        with span("train.cer"):
            if self.cfg.train.device_cer and "cer_dist" in metrics:
                return (int(metrics["cer_dist"]),
                        max(int(metrics["cer_chars"]), 1))
            if (n + 1) % max(self.cfg.train.train_cer_every, 1) == 0 \
                    and self.is_root:
                return batch_cer(hyp.cpu().numpy(), gold.cpu().numpy(),
                                 self.vocab)
            return 0, 1

    def _shard(self, batch: Dict[str, np.ndarray], task_axis: bool
               ) -> Dict[str, np.ndarray]:
        """This rank's slice of a host batch (the batch itself without a
        mesh)."""
        if self.mesh is None:
            return batch
        return shard_batch(batch, self.mesh, task_axis)

    def _stop_all(self, stop: bool) -> bool:
        """Rank 0's early-stop decision, on every rank."""
        if self.mesh is None:
            return stop
        return comm.broadcast_flag(stop, self.mesh.world, self.device)


    # -- the loop shared by the trainers; the subclasses' hooks: ---------
    # make_optimizer(), make_step(opt), fetch(dataset, rng) (draws one
    # batch from rng, default the dataset's), run_step(step, state, batch,
    # generator, beta) -> (state, loss, hyp, gold, the step's metrics), and
    # the learning rate the TRAIN line prints, ``logged_lr``

    def _build_state(self, opt, strict: bool = False) -> TrainState:
        """Seeded init (the discriminator's state built after the model's),
        or the checkpoint of ``--continue-from``: its weights, and its step
        and optimizer states when they have the structure of this run's
        (mtl_tpu/train/trainer.py:329-356, 603-626); ``strict`` raises
        instead of keeping the weights alone."""
        cfg = self.cfg
        init_weights(self.model, torch.Generator().manual_seed(cfg.train.seed))
        state = init_train_state(self.model, opt)
        if self.discriminator is not None:
            state = init_disc_state(self.discriminator, cfg, state)
        if cfg.continue_from:
            _, _, state_dict, _, _ = load_checkpoint(cfg.continue_from)
            self.model.load_state_dict(state_dict)
            saved = load_train_state(cfg.continue_from)
            if not (saved is not None and self._restore(state, saved)) \
                    and strict:
                raise ValueError(f"{cfg.continue_from}: the checkpoint's "
                                 f"optimizer state does not fit this run's")
            log_print(f"RESTORED STATE from {cfg.continue_from}")
        if self.mesh is not None:
            replicate_state(self.model, state, self.mesh)
        return state

    def _place_state(self, state: TrainState) -> TrainState:
        """After the mesh's refusals: under tensor parallel, this rank's
        slices of the replicated state (``tp.shard_state``)."""
        if self.sharded and getattr(self.model, "tp_axis", None) is None:
            tp.shard_state(self.model, state, self.mesh.model)
        return state

    def _restore(self, state: TrainState, saved: dict) -> bool:
        """Copies the step and optimizer state(s) of a training checkpoint
        into ``state`` when all of them fit, else nothing."""
        saved = dict(saved)
        step, disc = saved.pop("step"), saved.pop("disc", None)
        if not opt_state_fits(state.opt_state, saved):
            return False
        if self.discriminator is not None:
            if disc is None:
                return False
            disc = dict(disc)
            disc_params = disc.pop("params")
            if set(disc_params) != set(state.disc_params) \
                    or not opt_state_fits(state.disc_opt_state, disc):
                return False
            with torch.no_grad():
                for name, p in state.disc_params.items():
                    p.copy_(disc_params[name])
            restore_opt_state(state.disc_opt_state, disc)
        restore_opt_state(state.opt_state, saved)
        state.step = step
        return True

    def _save(self, state: TrainState, step: int, metrics: Optional[dict],
              best_model: bool = False,
              train_step: Optional[int] = None) -> None:
        """``model.pt`` holds the ASR weights alone, so ``test_main``
        serves any training checkpoint; the optimizer state (at
        ``train_step``, default ``step``) and the discriminator go beside
        it. Under tensor parallel the evaluating ranks gather the full
        tensors together and rank 0 writes them."""
        if not self.evaluates:
            return
        state_dict = tp.full_state_dict(self.model)
        opt_state = tp.full_opt_state(state.opt_state, self.model)
        if not self.is_root:
            return
        disc = None
        if self.discriminator is not None:
            disc = (state.disc_params, state.disc_opt_state)
        save_checkpoint(self.cfg, self.vocab, state_dict, step,
                        metrics, best_model=best_model,
                        opt_state=opt_state, disc=disc,
                        train_step=train_step)

    def train(self, train_dataset: SpectrogramDataset,
              valid_sets: Sequence[SpectrogramDataset], start_it: int = 0,
              num_it: int = 1000, state: Optional[TrainState] = None,
              last_metrics: Optional[dict] = None) -> TrainState:
        cfg = self.cfg
        opt = self.make_optimizer()
        step_fn = self.make_step(opt)
        if state is None:
            # the JAX trainer's init batch: keeps the stream aligned
            self.fetch(train_dataset)
            state = self._build_state(opt)
        if self.mesh is not None:
            check_mesh(cfg, [self.mesh.shape[a] for a in ("task", "data")],
                       len(train_dataset.ids_list), self.mesh_kind)
            state = self._place_state(state)
        generator = rank_generator(self.device, cfg.train.seed, self.mesh)

        # the prefetch starts after the initial draw: two threads drawing
        # from the dataset's RandomState would reorder the stream; several
        # workers draw each iteration from its own RandomState
        if cfg.train.prefetch_workers > 1:
            prefetch = MultiWorkerPrefetcher(
                lambda i: self.fetch(train_dataset,
                                     iteration_rng(cfg.train.seed, i)),
                cfg.train.prefetch_workers, start=start_it)
        else:
            prefetch = Prefetcher(lambda: self.fetch(train_dataset))
        profiler = _IterationProfiler(cfg, self.device, start_it,
                                      self.is_root)
        try:
            return self._loop(state, step_fn, prefetch, profiler, generator,
                              valid_sets, start_it, num_it, last_metrics)
        finally:
            prefetch.stop()
            profiler.close()

    def _loop(self, state, step_fn, prefetch, profiler, generator,
              valid_sets, start_it, num_it, last_metrics) -> TrainState:
        cfg = self.cfg
        stopper = EarlyStopper(cfg.train.early_stop)
        history: List[dict] = (last_metrics or {}).get("history", [])
        window = 100
        last_sum_loss, last_sum_cer, last_sum_char = (
            deque(maxlen=window), deque(maxlen=window), deque(maxlen=window)
        )
        total_time = 0.0
        beta = 1.0  # the adversarial weight under --beta-decay
        failures = 0
        it = start_it
        while it < num_it:
            profiler.at(it)
            with span("train.iteration"):
                # in-loop fault recovery (transient_trainer.py:364-377,
                # joint_trainer.py:391-405): a data error drops the batch,
                # refetches and keeps `it`
                try:
                    batch, error = prefetch.get(), None
                except Exception as e:
                    batch, error = None, e
                if self.mesh is not None and comm.any_flag(
                        error is not None, self.mesh.world, self.device) \
                        and error is None:
                    error = RuntimeError("a batch failed to load on another "
                                         "rank")
                if error is not None:
                    failures += 1
                    log_print(f"Error: {error!r}, fetching new data...")
                    if failures >= self.MAX_CONSECUTIVE_FAILURES:
                        raise error
                    continue
                failures = 0
                start_time = time.time()
                if cfg.train.beta_decay:  # meta_trainer.py:258-260
                    beta *= 0.99997
                state, loss, hyp, gold, m = self.run_step(
                    step_fn, state, batch, generator,
                    beta if cfg.train.beta_decay else 0.5)
                loss = float(loss)
                cer, nchar = self._train_cer(hyp, gold, m, it)
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
                            sum(last_sum_cer) * 100.0
                            / max(sum(last_sum_char), 1),
                        )
                    )

                if (it + 1) % cfg.train.evaluate_every == 0:
                    stop = False
                    if self.evaluates:
                        stop = self._evaluate_and_save(state, valid_sets, it,
                                                       stopper, history)
                    if self._stop_all(stop):
                        log_print("EARLY STOP")
                        break
                it += 1
        return state

    def _evaluate_and_save(self, state, valid_sets, it: int,
                           stopper: EarlyStopper, history: List[dict]
                           ) -> bool:
        """The evaluation of iteration ``it`` and its checkpoints; True
        when the early stop fires."""
        cfg = self.cfg
        avg_loss, avg_cer, vlosses, vcers = self.evaluate(valid_sets, it)
        metrics = {
            "avg_valid_loss": avg_loss,
            "avg_valid_cer": avg_cer,
            "valid_loss": vlosses,
            "valid_cer": vcers,
            "history": history,
        }
        history.append(dict(metrics, history=None))
        if (it + 1) % cfg.train.save_every == 0:
            self._save(state, it + 1, metrics)
        if stopper.update(avg_loss, avg_cer):
            self._save(state, it + 1, metrics, best_model=True)
        else:
            log_print(f"count_stop: {stopper.count}")
        return stopper.should_stop


class _IterationProfiler:
    """``--profile-dir``: a torch.profiler trace (host and, on a card, the
    device) from iteration ``start + 3`` to ``start + 8``, written as a
    Chrome trace under the directory, then the JAX package's ``PROFILE
    written to ...`` line (mtl_tpu/train/trainer.py:404-411). ``close()``
    ends a trace still running when the loop stops early. On a mesh rank 0
    alone traces (``enabled``)."""

    def __init__(self, cfg: Config, device: torch.device, start_it: int,
                 enabled: bool = True):
        self.dir = cfg.train.profile_dir if enabled else ""
        self.name = cfg.name
        self.device, self.start = device, start_it
        self.prof = None

    def at(self, it: int) -> None:
        if not self.dir:
            return
        if it == self.start + 3 and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif self.prof is not None and it == self.start + 8:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.dir, f"{self.name}_it{self.start + 4}.pt.trace.json"))
        log_print(f"PROFILE written to {self.dir}")


class TransientTrainer(TrainerBase):
    """Meta-transfer trainer (transient_trainer.py:79-377): the meta step
    (first or second order) with the shared code-switched query, outer Adam
    at ``meta_lr``. Where ``graphs.graphs_engage`` says so (a card, one
    process, first order, no head, no remat), the step is a
    ``GraphedMetaStep``: eager at a batch shape's first sighting, a CUDA
    graph replayed from the second."""

    per_task_query = False

    def _build_state(self, opt, strict: bool = False) -> TrainState:
        state = super()._build_state(opt, strict)
        log_print("Parameters: {}(trainable), {}(non-trainable)".format(
            *compute_num_params(self.model)))
        return state

    @property
    def logged_lr(self) -> float:
        return self.cfg.train.meta_lr

    @property
    def mesh_kind(self) -> str:
        return "meta" if self.discriminator is None else "joint"

    def make_optimizer(self):
        return make_meta_optimizers(self.cfg)[1]

    def make_step(self, opt):
        if self.discriminator is not None:
            return make_meta_step_disc(self.model, self.discriminator,
                                       self.cfg, opt, self.per_task_query,
                                       mesh=self.mesh)
        if graphs_engage(self.device, self.cfg, self.mesh):
            return GraphedMetaStep(self.model, self.cfg, opt, self.device,
                                   self.per_task_query, space_id=self.space_id)
        return make_meta_step(self.model, self.cfg, opt, self.per_task_query,
                              space_id=self.space_id, mesh=self.mesh)

    def fetch(self, train_dataset: SpectrogramDataset, rng=None):
        cfg = self.cfg
        return train_dataset.sample_meta_batch(
            cfg.train.k_train, cfg.train.k_valid,
            per_task_query=self.per_task_query, rng=rng)

    def run_step(self, step_fn, state, batch, generator, beta):
        if isinstance(step_fn, GraphedMetaStep):  # it takes the host batch
            state, m = step_fn(state, *batch, generator, beta)
        else:
            # the shared query is sharded over data, MAML's over (task, data)
            with span("train.to_device"):
                support, query = [
                    batch_to_device(self._shard(b, task_axis), self.device)
                    for b, task_axis in zip(batch,
                                            (True, self.per_task_query))]
            state, m = step_fn(state, support, query, generator, beta)
        return (state, m["outer_loss"], m["support_hyp"], m["support_gold"],
                m)


class MetaTrainer(TransientTrainer):
    """Standard MAML (meta_trainer.py): each task's own query batch."""

    per_task_query = True


def make_adapt_fn(model: torch.nn.Module, cfg: Config):
    """One inner-SGD step of meta-test (meta_trainer.py:330-458;
    mtl_tpu/train/trainer.py:503): ``adapt(params, batch, generator)``
    returns the weights after one step of ``lr`` on the batch's CE, in
    training mode (dropout on), with the optional clip. First order under
    ``--second-order`` too; its backward runs with TF32 off, so the plain
    VGG stack of that route differentiates in true f32 as in the meta
    step."""
    forward = make_forward_fn(model, cfg)

    def adapt(params: Dict[str, torch.Tensor], batch, generator
              ) -> Dict[str, torch.Tensor]:
        names = list(params)
        loss, _ = forward(params, batch, generator, False)
        with strict_f32():
            g = list(torch.autograd.grad(loss, [params[n] for n in names]))
        if cfg.train.clip:
            g = _clip_tree(g, cfg.train.max_norm,
                           tp=tp_split(model, names))
        with torch.no_grad():
            return dict(zip(names, torch._foreach_add(
                [params[n] for n in names], g, alpha=-cfg.train.lr)))

    return adapt


def meta_evaluate(trainer: TrainerBase, params: Dict[str, torch.Tensor],
                  train_dataset: SpectrogramDataset,
                  valid_sets: Sequence[SpectrogramDataset],
                  num_meta_test: int = 1, adapt_manifest_id: int = -1
                  ) -> Tuple[float, float]:
    """Meta-test (mtl_tpu/train/trainer.py:522): per trial, one inner step
    on a support draw of the (default: target) manifest, then no-grad
    validation at the adapted weights; the averages over the trials."""
    cfg = trainer.cfg
    adapt = make_adapt_fn(trainer.model, cfg)
    generator = torch.Generator(trainer.device).manual_seed(
        cfg.train.seed + 7)
    mid = adapt_manifest_id % len(train_dataset.ids_list)
    losses, cers = [], []
    for trial in range(max(1, num_meta_test)):
        support, _ = train_dataset.sample_meta_batch(
            cfg.train.k_train, 1, query_manifest_id=mid)
        batch = batch_to_device({k: v[mid] for k, v in support.items()},
                                trainer.device)
        adapted = adapt(params, batch, generator)
        avg_loss, avg_cer, _, _ = trainer.evaluate(valid_sets, trial,
                                                   params=adapted)
        losses.append(avg_loss)
        cers.append(avg_cer)
    n = len(losses)
    log_print("(Meta-test) trials={} AVG LOSS:{:.4f} AVG CER:{:.2f}%".format(
        n, sum(losses) / n, sum(cers) / n))
    return sum(losses) / n, sum(cers) / n


class JointTrainer(TrainerBase):
    """Iteration-based multi-task trainer (joint_trainer.py), also the
    finetune path (finetune.py:199-200): the joint step, Adam at ``lr`` or
    SGD with nesterov momentum (``--opt_name sgd``), optionally with the
    discriminator head."""

    mesh_kind = "joint"

    @property
    def logged_lr(self) -> float:
        return self.cfg.train.lr

    def make_optimizer(self):
        return make_joint_optimizer(self.cfg)

    def make_step(self, opt):
        if self.discriminator is not None:
            return make_joint_step_disc(self.model, self.discriminator,
                                        self.cfg, opt, mesh=self.mesh)
        return make_joint_step(self.model, self.cfg, opt,
                               space_id=self.space_id, mesh=self.mesh)

    def fetch(self, train_dataset: SpectrogramDataset, rng=None):
        # the JAX trainer's draw: every task's k_train support batch and a
        # query of one utterance, which it drops
        return train_dataset.sample_meta_batch(self.cfg.train.k_train, 1,
                                               rng=rng)[0]

    def run_step(self, step_fn, state, batch, generator, beta):
        state, loss, aux = step_fn(
            state, batch_to_device(self._shard(batch, True), self.device),
            generator, beta)
        return state, loss, aux["hyp"], aux["gold"], aux


class EpochTrainer(TrainerBase):
    """The classic epoch loop (reference trainer/asr/trainer.py;
    mtl_tpu/train/trainer.py:747) with Noam Adam: each epoch the shuffled
    batches of the train set as K = 1 joint steps (a failing batch is
    skipped), the epoch's TRAIN line, an evaluation, a checkpoint at
    ``epoch + 1`` (what a resume continues after) and the best model,
    written with step ``epoch`` as the JAX package writes it. On a mesh the
    batches are sharded over ``data`` alone (the trainer refuses ``task >
    1``), and a failing step raises: the other ranks are inside its
    collectives, so no rank can skip it alone."""

    mesh_kind = "epoch"

    def train(self, train_dataset: SpectrogramDataset,
              valid_sets: Sequence[SpectrogramDataset],
              start_epoch: int = 0, num_epochs: int = 10,
              state: Optional[TrainState] = None) -> TrainState:
        cfg = self.cfg
        opt = make_epoch_optimizer(cfg)
        step_fn = make_joint_step(self.model, cfg, opt,
                                  space_id=self.space_id, mesh=self.mesh)
        generator = rank_generator(self.device, cfg.train.seed, self.mesh)
        stopper = EarlyStopper(cfg.train.early_stop)
        if state is None:
            # the JAX trainer's example batch: it takes one shuffle of the
            # dataset's RandomState before epoch 0
            next(train_dataset.iter_batches(cfg.data.batch_size))
            state = self._build_state(opt, strict=True)
        if self.mesh is not None:
            check_mesh(cfg, [self.mesh.shape[a] for a in ("task", "data")],
                       len(train_dataset.ids_list), self.mesh_kind)
            state = self._place_state(state)
        for epoch in range(start_epoch, num_epochs):
            total_loss, total_cer, total_char, n = 0.0, 0, 0, 0
            failures = 0
            for batch in train_dataset.iter_batches(cfg.data.batch_size):
                batch = {k: v[None] for k, v in batch.items()}
                if self.mesh is not None:
                    batch = shard_batch_prefix(batch, self.mesh,
                                               (None, "data"))
                # per-batch skip on error (reference trainer.py:132-171)
                try:
                    state, loss, aux = step_fn(
                        state, batch_to_device(batch, self.device), generator)
                    cer, nchar = self._train_cer(aux["hyp"], aux["gold"], aux,
                                                 n)
                except Exception as e:
                    if self.mesh is not None:
                        raise
                    failures += 1
                    log_print(f"Error: {e!r}, skipping batch...")
                    if failures >= self.MAX_CONSECUTIVE_FAILURES:
                        raise
                    continue
                failures = 0
                total_loss += float(loss)
                total_cer += cer
                total_char += max(nchar, 1)
                n += 1
            log_print("(Epoch {}) TRAIN LOSS:{:.4f} CER:{:.2f}%".format(
                epoch, total_loss / max(n, 1),
                total_cer * 100.0 / max(total_char, 1)))
            stop = False
            if self.evaluates:
                avg_loss, avg_cer, _, _ = self.evaluate(valid_sets, epoch)
                # the optimizer's step count rides along: an epoch is many
                self._save(state, epoch + 1, {"avg_valid_loss": avg_loss,
                                              "avg_valid_cer": avg_cer},
                           train_step=state.step)
                if stopper.update(avg_loss, avg_cer):
                    self._save(state, epoch, None, best_model=True,
                               train_step=state.step)
                stop = stopper.should_stop
            if self._stop_all(stop):
                log_print("EARLY STOP")
                break
        return state
