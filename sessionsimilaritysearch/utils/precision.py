"""Precision policies.

Serving with bf16 parameters halves the bytes every embed forward reads
and runs its matmuls at the bf16 rate. Training
keeps f32 parameters; for serving/corpus builds, cast a trained tree once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cast_floats(tree, dtype=jnp.bfloat16):
    """Cast floating leaves of a pytree (params) to ``dtype``; integer and
    bool leaves pass through."""
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, tree)


def serving_params(params, use_bf16: bool = True):
    """The recommended serving-time parameter tree."""
    return cast_floats(params, jnp.bfloat16) if use_bf16 else params
