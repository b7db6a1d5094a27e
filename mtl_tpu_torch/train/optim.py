"""The optimizers of the port's trainers (mtl_tpu/train/optim.py): the
meta-transfer pair (:61-67; reference transient_trainer.py:105-109), inner
SGD at ``lr`` applied by hand inside the meta step and outer Adam at
``meta_lr``; and the joint/finetune optimizer (:54-58; reference
joint_trainer.py:123-132), Adam at ``lr`` or, with ``--opt_name sgd``, SGD
with nesterov momentum.

``Adam`` is ``optax.adam``'s update with its defaults (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0, bias-corrected):

    mu <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2;   n <- n + 1
    p  <- p - lr * (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)

in f32 on named parameters, with the multi-tensor ``torch._foreach_*`` ops
so that one update costs a handful of launches. Its state (``count``,
``mu``, ``nu`` keyed by parameter name) is what a checkpoint stores and what
``interop.py`` maps onto optax's ``ScaleByAdamState``. A step replayed as
a CUDA graph (``train/graphs.py``) cannot take the bias corrections as host
floats, which a capture would freeze: it passes ``update`` a
``DeviceBiasCorrection``, f32 scalars on the card that the host writes
before each step, and the update reads them with the arithmetic the floats
get.

``SGD`` is ``optax.sgd(lr, momentum, nesterov)``. With momentum its state is
optax's ``TraceState`` (the trace by parameter name):

    trace <- g + momentum * trace
    p     <- p - lr * (g + momentum * trace if nesterov else trace)

and without momentum (optax's ``EmptyState``) it holds nothing. A state
restores only into an optimizer of the same structure, as an orbax
restore into a typed target does (``restore_opt_state``).

``NoamAdam`` is the epoch trainer's optimizer (:21-47, :70-77; reference
utils/optimizer.py:3-32), optax's chain of ``scale_by_adam(0.9, 0.98,
eps 1e-9)``, ``scale_by_schedule`` and ``scale(-1)``: Adam's update at
the rate

    max(min_lr, k_lr * d^-0.5 * min(s^-0.5, s * warmup^-1.5)),  s = n + 1

with ``n`` the schedule's own count before the step. Its state is Adam's
fields plus that count (``NoamState``), so it restores neither into plain
Adam nor the reverse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..parallel import comm


@dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def tensors(self) -> dict:
        """What a checkpoint stores, by field."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}


@dataclass
class SGDState:
    """The momentum trace by parameter name; None without momentum."""
    trace: Optional[Dict[str, torch.Tensor]]

    def tensors(self) -> dict:
        return {} if self.trace is None else {"trace": self.trace}


@dataclass
class NoamState(AdamState):
    """Adam's fields and the schedule's count (optax's
    ``ScaleByScheduleState``)."""
    schedule_count: int = 0

    def tensors(self) -> dict:
        return dict(super().tensors(), schedule_count=self.schedule_count)


OptState = Union[AdamState, SGDState, NoamState]


def opt_state_fits(state: OptState, saved: dict) -> bool:
    """Whether a checkpoint's optimizer fields (``tensors()`` of a saved
    state) have the fields and parameter names of ``state``."""
    mine = state.tensors()
    return set(saved) == set(mine) and all(
        set(saved[k]) == set(v) for k, v in mine.items()
        if isinstance(v, dict))


def restore_opt_state(state: OptState, saved: dict) -> bool:
    """Copies a checkpoint's optimizer fields into ``state`` in place when
    they fit it (``opt_state_fits``); returns False, copying nothing,
    otherwise."""
    if not opt_state_fits(state, saved):
        return False
    for k, v in state.tensors().items():
        if isinstance(v, dict):
            for name, t in v.items():
                t.copy_(saved[k][name])
        else:
            setattr(state, k, saved[k])
    return True


class DeviceBiasCorrection:
    """Adam's two bias corrections as f32 scalars on ``device``, written by
    the host before each step (``write``) and read by the update
    (``divide``), so that a captured update divides by each step's own.
    ``torch._foreach_div`` by a host float multiplies by the float's
    reciprocal, rounded to f32, on CUDA, and divides by the float rounded to
    f32 on the CPU; the scalars hold what each device uses and ``divide``
    applies it alike, so both forms give the same bits. Graphs run only on
    a card; the CPU's reading is there for the CPU tests of the graphed
    step's policy (``tests/test_torch_port_graphs.py``), which run it
    through a stand-in graph."""

    def __init__(self, device: torch.device):
        self.reciprocal = device.type == "cuda"
        self.values = [torch.zeros((), dtype=torch.float32, device=device)
                       for _ in range(2)]

    def write(self, bc1: float, bc2: float) -> None:
        for t, v in zip(self.values, (bc1, bc2)):
            t.fill_(1.0 / v if self.reciprocal else v)

    def divide(self, tensors: List[torch.Tensor], i: int
               ) -> List[torch.Tensor]:
        """``tensors`` over bias correction ``i`` (0: b1's, 1: b2's)."""
        op = torch._foreach_mul if self.reciprocal else torch._foreach_div
        return op(tensors, self.values[i])


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def bias_corrections(self, count: int) -> Tuple[float, float]:
        """(1 - b1^n, 1 - b2^n) after ``count`` = n updates."""
        return 1.0 - self.b1 ** count, 1.0 - self.b2 ** count

    @staticmethod
    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor],
               corrections: Optional[DeviceBiasCorrection] = None
               ) -> AdamState:
        """Applies one step to ``params`` and ``state`` in place; with
        ``corrections`` (a graph-replayed step's) the bias corrections are
        read from the device instead of computed from ``state.count``."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        count = state.count + 1
        torch._foreach_lerp_(mu, g, 1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        # optax divides each moment by its bias correction in f32
        if corrections is None:
            bc1, bc2 = self.bias_corrections(count)
            denom = torch._foreach_div(nu, bc2)
        else:
            denom = corrections.divide(nu, 1)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = (torch._foreach_div(mu, bc1) if corrections is None
                else corrections.divide(mu, 0))
        torch._foreach_div_(step, denom)
        torch._foreach_add_(p, step, alpha=-self.lr)
        state.count = count
        return state


def noam_schedule(model_size: int, factor: float, warmup: int,
                  min_lr: float) -> Callable[[int], float]:
    """The Noam rate at the 0-based step count (mtl_tpu/train/optim.py:21;
    NoamOpt counts from 1), in f32 as the JAX package computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        s = f32(count + 1)
        rate = f32(factor * model_size ** -0.5) * min(
            s ** f32(-0.5), s * f32(warmup ** -1.5))
        return float(max(rate, f32(min_lr)))

    return schedule


class NoamAdam(Adam):
    """Adam(0.9, 0.98, eps 1e-9) at the Noam rate
    (mtl_tpu/train/optim.py:34 ``noam_adam``)."""

    def __init__(self, model_size: int, factor: float, warmup: int,
                 min_lr: float):
        super().__init__(0.0, b1=0.9, b2=0.98, eps=1e-9)
        self.schedule = noam_schedule(model_size, factor, warmup, min_lr)

    @staticmethod
    def init(params: Dict[str, torch.Tensor]) -> NoamState:
        adam = Adam.init(params)
        return NoamState(adam.count, adam.mu, adam.nu, 0)

    def update(self, grads: Dict[str, torch.Tensor], state: NoamState,
               params: Dict[str, torch.Tensor]) -> NoamState:
        self.lr = self.schedule(state.schedule_count)
        super().update(grads, state, params)
        state.schedule_count += 1
        return state


class SGD:
    def __init__(self, lr: float, momentum: float = 0.0,
                 nesterov: bool = False):
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov

    def init(self, params: Dict[str, torch.Tensor]) -> SGDState:
        if not self.momentum:
            return SGDState(None)
        return SGDState({k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: SGDState,
               params: Dict[str, torch.Tensor]) -> SGDState:
        """Applies one step to ``params`` and ``state`` in place."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        step = g
        if self.momentum:
            trace = [state.trace[k] for k in names]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            step = (torch._foreach_add(g, trace, alpha=self.momentum)
                    if self.nesterov else trace)
        torch._foreach_add_(p, step, alpha=-self.lr)
        return state


def make_joint_optimizer(cfg: Config) -> Union[Adam, SGD]:
    """Adam(lr), or with ``--opt_name sgd`` SGD(lr, momentum, nesterov)."""
    if cfg.train.opt_name == "sgd":
        return SGD(cfg.train.lr, cfg.train.momentum, nesterov=True)
    return Adam(cfg.train.lr)


def make_meta_optimizers(cfg: Config) -> Tuple[float, Adam]:
    """(inner SGD lr, outer Adam at meta_lr)."""
    return cfg.train.lr, Adam(cfg.train.meta_lr)


def make_epoch_optimizer(cfg: Config) -> Union[NoamAdam, SGD]:
    """The epoch trainer's optimizer (mtl_tpu/train/optim.py:70-76): for
    CE, Noam Adam with d = ``cfg.model.dim_input``, the JAX package's
    argument (the encoder's input width, not d_model); for CTC, SGD at
    ``lr`` with nesterov ``momentum`` (the reference's AnnealingOpt, whose
    ``--lr-anneal`` the JAX package never applies, so neither does the
    port)."""
    if cfg.train.loss != "ce":
        return SGD(cfg.train.lr, cfg.train.momentum, nesterov=True)
    return NoamAdam(cfg.model.dim_input, cfg.train.k_lr, cfg.train.warmup,
                    cfg.train.min_lr)


def global_norm(tensors: List[torch.Tensor],
                split: Optional[List[bool]] = None, axis=None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    With ``axis`` (a sharded model's, parallel/tp.py), the tensors that
    ``split`` flags are this rank's slices of tensors split over it: their
    squares are summed over the axis, the replicated ones counted once."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if axis is None:
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(split, device=norms.device)
    squares = norms.square()
    return (comm.all_reduce(squares[mask].sum(), axis)
            + squares[~mask].sum()).sqrt()
