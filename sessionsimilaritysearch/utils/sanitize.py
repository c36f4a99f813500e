"""Numerical and purity sanitizers (SURVEY.md §5 "race detection /
sanitizers" row).

The reference guards numerics with an assert storm inside every module
(NaN asserts at each encoder stage, model/model.py:223-247,
model/NodeEmbedding.py:86-97; per-loss asserts,
pretrain_filtered_amazon.py:492-497) plus
``torch.autograd.set_detect_anomaly(True)``
(pretrain_filtered_amazon.py:344). Under ``jax.jit`` inline asserts cannot
exist (tracing), so the equivalents live OUTSIDE the computation:

- :func:`debug_nans`: scoped ``jax.config.jax_debug_nans`` -- any NaN/Inf
  produced by a jitted computation raises at the op that made it (JAX
  re-runs un-jitted to localize). The test-time replacement for the
  reference's per-stage asserts; production keeps the cheaper
  loss-is-finite rollback in training.loop (nan_recovery).
- :func:`assert_pure`: calls a function twice on the same inputs and
  asserts bit-identical outputs -- catches hidden host state, impure RNG
  use, and data races in host callbacks, the closest JAX analogue of a
  race sanitizer for the functional compute path.
- :func:`assert_donates`: asserts a donated buffer is actually consumed
  (deleted) by a jitted call -- a silently-ignored donation doubles peak
  device memory on multi-GB corpus/optimizer buffers, which can be the
  difference between fitting and OOM.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import jax
import numpy as np


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN debugging: inside the context, any jitted computation
    that produces a non-finite value raises immediately (localized by
    JAX's de-optimized re-run) instead of propagating silently."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def _leaves_equal(a: Any, b: Any) -> bool:
    la, sa = jax.tree_util.tree_flatten(a)
    lb, sb = jax.tree_util.tree_flatten(b)
    if sa != sb:
        return False
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        # bitwise comparison: purity means identical BITS, not just close
        # (reshape first: 0-d arrays cannot re-view at a different itemsize)
        if x.dtype.kind == "f":
            x = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
            y = np.ascontiguousarray(y).reshape(-1).view(np.uint8)
        if not np.array_equal(x, y):
            return False
    return True


def assert_pure(fn: Callable, *args, **kwargs) -> Any:
    """Run ``fn`` twice on identical inputs and assert bit-identical
    outputs. Catches hidden host state (mutable defaults, caches keyed
    wrongly), impure RNG, and racing host callbacks. Returns the first
    result so callers can keep using it."""
    out1 = jax.block_until_ready(fn(*args, **kwargs))
    out2 = jax.block_until_ready(fn(*args, **kwargs))
    if not _leaves_equal(out1, out2):
        raise AssertionError(
            f"{getattr(fn, '__name__', fn)!r} is impure: two calls on "
            "identical inputs returned different results"
        )
    return out1


def assert_donates(fn: Callable, donated_arg, *rest, **kwargs) -> Any:
    """Call ``fn(donated_arg, *rest)`` and assert the donated buffer was
    consumed. ``fn`` must be a jitted callable whose first argument is
    donated (``donate_argnums=(0,)``); if the donation is silently dropped
    (e.g. shape/dtype mismatch with the output) peak memory doubles."""
    out = fn(donated_arg, *rest, **kwargs)
    jax.block_until_ready(out)
    if not donated_arg.is_deleted():
        raise AssertionError(
            f"{getattr(fn, '__name__', fn)!r} did not consume its donated "
            "first argument -- donation silently ignored (peak memory doubles)"
        )
    return out
