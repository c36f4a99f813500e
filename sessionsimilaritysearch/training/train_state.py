"""Train-state plumbing shared by all drivers.

The reference keeps torch modules + up to three Adam optimizers per driver
(e.g. pretrain_filtered_amazon.py:328-343). Here a single TrainState
(params + batch_stats + optax state) carries everything; "multiple
optimizers stepping together at the same lr" collapses to one Adam, and the
fine-tuners' alternating two-tower scheme is expressed with optax
multi_transform masks instead (training/finetune.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import optax


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, parameters, optimizer state and BatchNorm statistics
    as one pytree; ``apply_fn`` and ``tx`` are static (hashed by jit)."""

    step: Any
    apply_fn: Callable = dataclasses.field(metadata={"static": True})
    params: Any
    tx: optax.GradientTransformation = dataclasses.field(
        metadata={"static": True}
    )
    opt_state: Any
    batch_stats: Any = None

    @classmethod
    def create(cls, *, apply_fn: Callable, params, tx, **kwargs):
        return cls(step=0, apply_fn=apply_fn, params=params, tx=tx,
                   opt_state=tx.init(params), **kwargs)

    def apply_gradients(self, *, grads, **kwargs) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state,
            **kwargs,
        )

    def replace(self, **kwargs) -> "TrainState":
        return dataclasses.replace(self, **kwargs)


jax.tree_util.register_dataclass(TrainState)


def adam_with_clip(lr: float, clip_norm: float = 1.0, weight_decay: float = 0.0):
    """Adam + global-norm clipping (the reference clips to 1.0 before every
    step, pretrain_filtered_amazon.py:504)."""
    tx = [optax.clip_by_global_norm(clip_norm)]
    if weight_decay > 0:
        tx.append(optax.adamw(lr, weight_decay=weight_decay))
    else:
        tx.append(optax.adam(lr))
    return optax.chain(*tx)


def create_train_state(
    module,
    rng,
    init_args: tuple,
    tx,
    init_kwargs: Optional[dict] = None,
) -> TrainState:
    variables = module.init(rng, *init_args, **(init_kwargs or {}))
    params = variables["params"]
    batch_stats = variables.get("batch_stats")
    return TrainState.create(
        apply_fn=module.apply,
        params=params,
        tx=tx,
        batch_stats=batch_stats,
    )
