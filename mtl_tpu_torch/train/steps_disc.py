"""The adversarial and multitask discriminator heads of the training steps
(port of mtl_tpu/train/steps_disc.py; reference
trainer/asr/joint_trainer.py:196-271 and meta_trainer.py:243-263).

Task k's encoder output, summed over time, feeds the discriminator; the
terms added to that task's loss are

    adversarial:  beta * disc_ce_k + mse_to_uniform_k
    multitask:    disc_ce_k

with no gradient reversal (the discriminator's CE reaches the encoder, as
in the reference). The steps themselves are ``train/steps.py``'s joint and
meta steps with a ``DiscHead``: one backward reaches both parameter sets,
and the model and the discriminator take their own updates. The
discriminator's optimizer is plain SGD at ``lr_disc`` under ``--opt_name
sgd`` (no momentum), else Adam at ``lr_disc`` (:74-76).

On a mesh the discriminator is replicated like the model (never sharded,
as mtl_tpu/train/trainer.py:633-637 keeps it; with a ``model`` axis the
model stays replicated too, and every rank of the axis runs the same
step): its gradients are reduced with the model's over the plane, and its
batch means are this rank's share of the global batch's (equal shards over
``data``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple, Union

import torch

from ..config import Config
from ..models.discriminator import Discriminator, init_discriminator
from ..parallel import comm
from .losses import adversarial_losses
from .optim import SGD, Adam, OptState
from .steps import TrainState, make_joint_step, make_meta_step


@dataclass
class DiscTrainState(TrainState):
    """The model's ``TrainState`` and the discriminator's parameters (its
    own, by name) and optimizer state (mtl_tpu/train/steps_disc.py:52)."""

    disc_params: Dict[str, torch.Tensor]
    disc_opt_state: OptState


def disc_optimizer(cfg: Config) -> Union[SGD, Adam]:
    if cfg.train.opt_name == "sgd":
        return SGD(cfg.train.lr_disc)
    return Adam(cfg.train.lr_disc)


def init_disc_state(discriminator: Discriminator, cfg: Config,
                    base: TrainState) -> DiscTrainState:
    """Seeded discriminator weights (seed + 1, as the JAX package seeds
    its init; the values differ, parity rests on interop) and a fresh
    state of its optimizer beside ``base``."""
    init_discriminator(discriminator,
                       torch.Generator().manual_seed(cfg.train.seed + 1))
    params = dict(discriminator.named_parameters())
    return DiscTrainState(base.step, base.params, base.opt_state, params,
                          disc_optimizer(cfg).init(params))


class DiscHead:
    """The discriminator's terms of a task's loss, and its update."""

    def __init__(self, discriminator: Discriminator, cfg: Config):
        self.discriminator = discriminator
        self.adversarial = cfg.train.adversarial
        self.optimizer = disc_optimizer(cfg)
        self.mesh = None

    def on_mesh(self, mesh) -> None:
        """Runs the head on this rank's slice of a ``mesh`` (None: one
        process)."""
        self.mesh = mesh

    @staticmethod
    def params(state: DiscTrainState) -> List[torch.Tensor]:
        return list(state.disc_params.values())

    def update(self, state: DiscTrainState,
               grads: List[torch.Tensor]) -> None:
        """One step of the discriminator's optimizer, in place."""
        self.optimizer.update(dict(zip(state.disc_params, grads)),
                              state.disc_opt_state, state.disc_params)

    def terms(self, enc: torch.Tensor, accent_id: int, beta: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(the term added to the task's loss, disc CE, encoder MSE)."""
        disc_l, enc_l = adversarial_losses(self.discriminator(enc),
                                           accent_id)
        if self.mesh is not None:
            # batch means: this shard's share of the global batch's
            disc_l, enc_l = (x / self.mesh.data.size for x in (disc_l, enc_l))
        term = beta * disc_l + enc_l if self.adversarial else disc_l
        return term, disc_l, enc_l

    def metrics(self, terms: List[tuple], k: int
                ) -> Dict[str, torch.Tensor]:
        """The mean over the K tasks of the disc CE and encoder MSE."""
        if self.mesh is None:
            return {name: torch.stack([t[i] for t in terms]).mean().detach()
                    for i, name in ((1, "disc_loss"), (2, "enc_loss"))}
        sums = comm.all_reduce_list(
            [torch.stack([t[i] for t in terms]).sum().detach()
             for i in (1, 2)], self.mesh.plane)
        return {"disc_loss": sums[0] / k, "enc_loss": sums[1] / k}


def make_joint_step_disc(model, discriminator: Discriminator, cfg: Config,
                         optimizer, mesh=None) -> Callable:
    """mtl_tpu/train/steps_disc.py:189: the joint step with the head."""
    return make_joint_step(model, cfg, optimizer,
                           head=DiscHead(discriminator, cfg), mesh=mesh)


def make_meta_step_disc(model, discriminator: Discriminator, cfg: Config,
                        outer_optimizer, per_task_query: bool = False,
                        mesh=None) -> Callable:
    """mtl_tpu/train/steps_disc.py:77: the first-order meta step with the
    head on each task's query loss (``make_meta_step`` refuses
    ``--second-order`` with a head, as :91-98 does)."""
    return make_meta_step(model, cfg, outer_optimizer, per_task_query,
                          head=DiscHead(discriminator, cfg), mesh=mesh)
