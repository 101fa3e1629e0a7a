"""Expert parallelism: the context that selects ``MoEFeedForward``'s
all_to_all form (the counterpart of the reference's ambient mesh,
``jax.set_mesh`` in ``ShardedTrainer.train_step``).

A MoE layer whose expert stacks are blocks over the model group (``E/m``
experts a rank, cut by ``param_spec``) runs one of two forms, both equal
to the world-1 layer within f32 rounding (``nn/moe.py``):

- the fallback, under ``tp.model_parallel`` alone (what
  ``InferenceEngine.parallel()`` enters): every rank routes every token,
  runs its experts on them and the partial combines are summed over
  ``model`` (one all-reduce a layer);
- the all_to_all form, under ``ep_parallel(group)`` as well (what
  ``ShardedTrainer`` enters): each rank routes its ``B/m`` batch rows,
  swaps the dispatched tokens to the experts' ranks and back
  (``tp.all_to_all_model``) and all-gathers the combined rows.

``group`` must be the active model group.
"""

from __future__ import annotations

import contextlib

_GROUP: list = [None]  # the model group that carries the all_to_all


@contextlib.contextmanager
def ep_parallel(group):
    """Run the enclosed MoE layers (and their backward) in the all_to_all
    form over ``group``."""
    prev = _GROUP[0]
    _GROUP[0] = group
    try:
        yield
    finally:
        _GROUP[0] = prev


def ep_group():
    """The group bound by ``ep_parallel``; None outside it."""
    return _GROUP[0]
