"""Activation-layout constraints: the identity in the port.

Counterpart of ``repro.models.shardctx``.  JAX pins a few activation
layouts (vocab-sharded logits, a batch-sharded residual stream) for GSPMD,
which chooses the compute of a sharded step from them.  The port's sharded
train step (``launch.train.make_jitted_train_step``) computes ZeRO-3
style instead: each rank runs the whole model on its own rows with every
layer's weights gathered, so an activation on a rank is its rows, whole,
and no layout is left to pin.  ``constrain(x, *spec)`` returns ``x``
unchanged, off a mesh and on one.
"""
from __future__ import annotations


def constrain(x, *spec):
    """``x`` as it is (module docstring)."""
    return x
