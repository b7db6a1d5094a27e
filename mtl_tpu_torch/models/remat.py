"""Activation recomputation for ``--remat`` and ``--remat-conv`` (the JAX
package's ``nn.remat`` over each encoder layer or Conformer block and over
the conv front-end; mtl_tpu/models/encoder.py:89-90, conformer.py:179-183,
transformer.py:52-53).

``checkpoint_module`` runs a module under ``torch.utils.checkpoint``
(non-reentrant, so ``torch.autograd.grad`` and a double backward work
through it) so that its activations are dropped after the forward and
recomputed in the backward. Two things would go wrong with a bare
``checkpoint(module, ...)``:

* dropout draws from the caller's ``torch.Generator``, which checkpoint's
  ``preserve_rng_state`` does not save: a recompute would draw other masks
  than the forward, and the backward would differentiate a function the
  forward never computed. The recompute starts the generator from the
  state the forward started from and puts it back after, so the masks are
  the forward's and the generator ends where it would without remat;
* the recompute runs after the call has returned, when a
  ``torch.func.functional_call`` that swapped the module's parameters (the
  meta step's adapted weights) has put the module's own back. The
  parameters the forward saw are captured and the recompute runs on them.

With both, remat changes neither the loss, the gradients nor the later
dropout stream. Without grad mode the module simply runs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint


def checkpoint_module(module: torch.nn.Module, *args,
                      gen: Optional[torch.Generator] = None):
    """``module(*args, gen=gen)`` (``module(*args)`` when ``gen`` is None)
    with its activations recomputed in the backward."""
    kwargs = {} if gen is None else {"gen": gen}
    if not torch.is_grad_enabled():
        return module(*args, **kwargs)
    # under a functional_call these are the swapped-in tensors
    params = dict(module.named_parameters())
    start = None if gen is None else gen.get_state()
    forward_done = False

    def run(*a):
        nonlocal forward_done
        if not forward_done or gen is None:
            forward_done = True
            return functional_call(module, params, a, kwargs)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return functional_call(module, params, a, kwargs)
        finally:
            gen.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
