"""Activation recompute (JAX ``nn.remat`` / ``jax.checkpoint``) for modules
that hold state.

``remat(module, *args)`` runs ``module(*args)`` under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
module's forward instead of keeping its activations. Two things a plain
checkpoint would get wrong are put right in the recompute:

* train-mode BatchNorm would move its running statistics a second time:
  the recompute runs under ``ops.norm.frozen_running_stats``, so they move
  once per step, as under JAX;
* dropout and drop-connect that draw from an explicit ``torch.Generator``
  (a module's ``generator`` attribute, ``nn.attention.set_dropout_generator``)
  would draw new numbers: the recompute starts each such generator at the
  state the forward saw and afterwards puts it back where it was. torch's
  default generators are restored by the checkpoint itself.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.norm import frozen_running_stats


def _generators(module: nn.Module):
    gens = {}
    for m in module.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            gens[id(g)] = g
    return list(gens.values())


@contextlib.contextmanager
def _recompute(module, gens, states):
    now = [g.get_state() for g in gens]
    for g, s in zip(gens, states):
        g.set_state(s)
    try:
        with frozen_running_stats(module):
            yield
    finally:
        for g, s in zip(gens, now):
            g.set_state(s)


def remat(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward."""
    gens = _generators(module)

    def contexts():
        states = [g.get_state() for g in gens]
        return contextlib.nullcontext(), _recompute(module, gens, states)

    return checkpoint(module, *args, use_reentrant=False, context_fn=contexts)
