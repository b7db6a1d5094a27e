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
``interop.py`` maps onto optax's ``ScaleByAdamState``.

``SGD`` is ``optax.sgd(lr, momentum, nesterov)``. With momentum its state is
optax's ``TraceState`` (the trace by parameter name):

    trace <- g + momentum * trace
    p     <- p - lr * (g + momentum * trace if nesterov else trace)

and without momentum (optax's ``EmptyState``) it holds nothing. A state
restores only into an optimizer of the same structure, as an orbax
restore into a typed target does (``restore_opt_state``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..config import Config


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


OptState = Union[AdamState, SGDState]


def restore_opt_state(state: OptState, saved: dict) -> bool:
    """Copies a checkpoint's optimizer fields (``tensors()`` of a saved
    state) into ``state`` in place when both have the same fields and
    parameter names; returns False, copying nothing, otherwise."""
    mine = state.tensors()
    if set(saved) != set(mine) or any(
            set(saved[k]) != set(v) for k, v in mine.items()
            if isinstance(v, dict)):
        return False
    for k, v in mine.items():
        if isinstance(v, dict):
            for name, t in v.items():
                t.copy_(saved[k][name])
        else:
            setattr(state, k, saved[k])
    return True


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    @staticmethod
    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor]) -> AdamState:
        """Applies one step to ``params`` and ``state`` in place."""
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
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(p, step, alpha=-self.lr)
        state.count = count
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


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))
