"""Generic host training loop.

Factored from the per-driver epoch loops of the reference (e.g.
pretrain_filtered_amazon.py:353-614, train_subsession_embedding.py:437-466):
iterate batches -> jitted step -> periodic validation -> keep the
best-valid-loss checkpoint -- plus what upstream lacks: restore-on-start
resume and structured metric logging.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.utils.checkpoint import (
    CheckpointManager,
    state_to_tree,
    tree_to_state,
)
from sessionsimilaritysearch.utils.logging import MetricLogger, RunDir


# Packed host->device transport. `jax.tree.map(jnp.asarray, batch)`
# uploads every leaf separately — a SessionGraph batch is ~30 arrays, and
# each upload pays its own host->device round trip. Packing concatenates
# all leaves of one dtype into ONE host buffer, uploads one buffer per
# dtype (typically 2), and slices/reshapes back on device inside a
# jitted unpack program — identical output pytree, O(1) round trips.
_PACK_CACHE: dict = {}


def _canon_np(leaf):
    """Canonicalize a host leaf the way jnp.asarray would (x64 disabled)."""
    a = np.asarray(leaf)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.uint64:
        a = a.astype(np.uint32)
    return a


def to_device(batch):
    """Move a host pytree to device with packed transport (one upload per
    distinct dtype + one jitted unpack). Leaves that are already jax
    arrays pass through untouched (e.g. device-resident zero fields in
    the campaign's cached-text mode)."""
    leaves, treedef = jax.tree.flatten(batch)
    host_ix = [i for i, l in enumerate(leaves)
               if not isinstance(l, jax.Array)]
    if not host_ix:
        return batch
    canon = {i: _canon_np(leaves[i]) for i in host_ix}
    key = (treedef, tuple(sorted(
        (i, canon[i].shape, canon[i].dtype.str) for i in host_ix
    )))
    entry = _PACK_CACHE.get(key)
    if entry is None:
        dev_ix = [i for i in range(len(leaves)) if i not in set(host_ix)]
        by_dtype: dict = {}
        for i in host_ix:
            by_dtype.setdefault(canon[i].dtype.str, []).append(i)
        order = sorted(by_dtype)
        specs = {
            dt: [(i, canon[i].shape, int(canon[i].size))
                 for i in by_dtype[dt]]
            for dt in order
        }

        @jax.jit
        def unpack(dev_leaves, *bufs):
            out = [None] * treedef.num_leaves
            for j, i in enumerate(dev_ix):
                out[i] = dev_leaves[j]
            for dt, buf in zip(order, bufs):
                off = 0
                for i, shape, size in specs[dt]:
                    out[i] = buf[off:off + size].reshape(shape)
                    off += size
            return jax.tree.unflatten(treedef, out)

        entry = _PACK_CACHE[key] = (dev_ix, order, specs, unpack)
    dev_ix, order, specs, unpack = entry
    bufs = [
        np.concatenate([canon[i].ravel() for i, _, _ in specs[dt]])
        if len(specs[dt]) > 1 else canon[specs[dt][0][0]].ravel()
        for dt in order
    ]
    return unpack([leaves[i] for i in dev_ix], *bufs)


def run_training(
    *,
    state,
    step_fn: Callable,
    train_loader: Iterable,
    epochs: int,
    rng,
    eval_fn: Optional[Callable] = None,
    valid_loader: Optional[Iterable] = None,
    rundir: Optional[RunDir] = None,
    ckpt: Optional[CheckpointManager] = None,
    resume: bool = True,
    log_every: int = 50,
    valid_metric: str = "loss",
    nan_recovery: bool = True,
):
    """Returns (final_state, best_valid_loss).

    ``step_fn(state, batch, rng) -> (state, metrics)``;
    ``eval_fn(state, batch, rng) -> metrics``.

    ``nan_recovery``: on a non-finite loss, roll back to the last saved
    checkpoint (or drop the poisoned update when none exists) instead of
    continuing with corrupted parameters -- the failure-detection story the
    reference lacks (SURVEY.md §5: its asserts only crash the run).
    """
    metrics_log = None
    if rundir is not None:
        metrics_log = MetricLogger(rundir.file("metrics.jsonl"), rundir.logger)

    best_valid = float("inf")
    own_latest = False  # whether 'latest' was written by THIS run
    if ckpt is not None and resume and ckpt.has("latest"):
        tree = ckpt.restore("latest", state_to_tree(state))
        state = tree_to_state(state, tree)
        own_latest = True
        # carry the best-so-far across restarts, or the first (typically
        # worse) post-resume validation would clobber the saved 'best'
        meta = ckpt.restore("loop_meta") if ckpt.has("loop_meta") else None
        if meta is not None and "best_valid" in meta:
            best_valid = float(np.asarray(meta["best_valid"]))
        if rundir:
            rundir.logger.info(
                f"resumed from step {int(state.step)}"
                f" (best_valid {best_valid:.4f})"
            )

    step_count = int(getattr(state, "step", 0))
    for epoch in range(epochs):
        epoch_losses = []
        t0 = time.time()
        for batch in train_loader:
            rng, sub = jax.random.split(rng)
            prev_state = state
            state, m = step_fn(state, to_device(batch), sub)
            step_count += 1
            loss = float(m["loss"])
            if nan_recovery and not np.isfinite(loss):
                # only roll back to a checkpoint THIS run owns; a stale
                # 'latest' from an earlier run must not leak into a
                # resume=False run
                if ckpt is not None and own_latest:
                    tree = ckpt.restore("latest", state_to_tree(prev_state))
                    state = tree_to_state(prev_state, tree)
                else:
                    state = prev_state  # drop the poisoned update
                if rundir:
                    rundir.logger.warning(
                        f"non-finite loss at step {step_count}; rolled back"
                    )
                continue
            epoch_losses.append(loss)
            if metrics_log and step_count % log_every == 0:
                metrics_log.log(step_count, **{k: v for k, v in m.items()})

        valid_loss = None
        if eval_fn is not None and valid_loader is not None:
            vals: Dict[str, list] = {}
            for batch in valid_loader:
                rng, sub = jax.random.split(rng)
                vm = eval_fn(state, to_device(batch), sub)
                for k, v in vm.items():
                    vals.setdefault(k, []).append(float(v))
            valid_loss = float(np.mean(vals.get(valid_metric, [np.inf])))
            if metrics_log:
                metrics_log.log(
                    step_count,
                    epoch=epoch,
                    **{f"valid_{k}": np.mean(v) for k, v in vals.items()},
                )
            if valid_loss < best_valid:
                best_valid = valid_loss
                if ckpt is not None:
                    ckpt.save("best", state_to_tree(state))

        if ckpt is not None:
            ckpt.save("latest", state_to_tree(state))
            ckpt.save("loop_meta", {"best_valid": np.asarray(best_valid)})
            own_latest = True
        if rundir:
            rundir.logger.info(
                "epoch %d: train %.4f%s (%.1fs)"
                % (
                    epoch,
                    float(np.mean(epoch_losses)) if epoch_losses else float("nan"),
                    f", valid {valid_loss:.4f}" if valid_loss is not None else "",
                    time.time() - t0,
                )
            )
    if metrics_log:
        metrics_log.close()
    return state, best_valid
