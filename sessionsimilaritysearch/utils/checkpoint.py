"""Checkpoint / resume.

The reference only saves (torch.save of module tuples on best valid loss,
pretrain_filtered_amazon.py:606-609) and never resumes mid-run (SURVEY.md
§5). Here: checkpointing of the full train state (params, batch_stats,
optimizer state, step; Orbax where it is installed, else one ``.npz`` per
tag) with keep-best + restore-on-start, so a preempted run continues from
its last step -- the elastic-recovery story the reference lacks.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np


def _to_pure(tree):
    return jax.tree.map(np.asarray, tree)


def _path_key(path) -> str:
    return "/".join(
        str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
        for p in path
    )


# numpy's .npz has no bfloat16 (or other ml_dtypes) type: such leaves are
# stored as raw unsigned words under "<path>@<dtype name>" and viewed back
_RAW_SEP = "@"


def save_npz(path: str, tree: Any) -> None:
    """Write a pytree's leaves to one ``.npz``, keyed by their tree paths
    (``params/encoder/kernel``); bfloat16 leaves keep their dtype."""
    out = {}
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(v)
        if a.dtype.kind == "V":  # an ml_dtypes type
            out[_path_key(p) + _RAW_SEP + a.dtype.name] = a.view(
                np.dtype(f"u{a.dtype.itemsize}"))
        else:
            out[_path_key(p)] = a
    np.savez(path, **out)


def load_npz(path: str, template: Optional[Any] = None) -> Any:
    """Read a :func:`save_npz` file: into ``template``'s structure when
    given (leaves matched by path), else as nested dicts."""
    import jax.numpy as jnp

    data = {}
    with np.load(path) as z:
        for k in z.files:
            key, _, dtype = k.partition(_RAW_SEP)
            data[key] = z[k].view(jnp.dtype(dtype)) if dtype else z[k]
    if template is not None:
        flat, treedef = jax.tree_util.tree_flatten_with_path(template)
        return jax.tree.unflatten(
            treedef, [data[_path_key(p)] for p, _ in flat]
        )
    out: dict = {}
    for key, value in data.items():
        *parents, leaf = key.split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = value
    return out


class CheckpointManager:
    """Thin wrapper over orbax.checkpoint, falling back to one ``.npz`` per
    tag where orbax is not installed; keeps ``latest`` plus an explicit
    ``best``."""

    def __init__(self, directory: str, use_orbax: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._ocp = None
        if use_orbax:
            try:
                import orbax.checkpoint as ocp

                self._ocp = ocp.PyTreeCheckpointer()
            except Exception:
                self._ocp = None

    def _path(self, tag) -> str:
        return os.path.join(self.directory, str(tag))

    def save(self, tag, tree: Any) -> None:
        tree = _to_pure(tree)
        path = self._path(tag)
        if self._ocp is not None:
            if os.path.exists(path):
                import shutil

                shutil.rmtree(path)
            self._ocp.save(path, tree)
        else:
            save_npz(path + ".npz", tree)

    def restore(self, tag, template: Optional[Any] = None) -> Optional[Any]:
        path = self._path(tag)
        if self._ocp is not None and os.path.isdir(path):
            return self._ocp.restore(
                path, item=_to_pure(template) if template is not None else None
            )
        if os.path.exists(path + ".npz"):
            return load_npz(path + ".npz", template)
        return None

    def has(self, tag) -> bool:
        path = self._path(tag)
        return os.path.isdir(path) or os.path.exists(path + ".npz")


def state_to_tree(state) -> dict:
    """TrainState -> serializable tree (params + batch_stats + opt + step)."""
    return {
        "step": np.asarray(state.step),
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
    }


def tree_to_state(state, tree) -> Any:
    """Rebuild a TrainState from a restored tree (template = current)."""
    return state.replace(
        step=int(np.asarray(tree["step"])),
        params=tree["params"],
        batch_stats=tree["batch_stats"],
        opt_state=jax.tree.unflatten(
            jax.tree.structure(state.opt_state),
            jax.tree.leaves(tree["opt_state"]),
        ),
    )


# ---------------------------------------------------------------------------
# Sharded checkpointing: save/restore device-sharded jax.Arrays shard by
# shard, never materializing a full array on the host. This is what lets
# >host-RAM corpora / optimizer states round-trip (SURVEY.md §5 plan; the
# reference's torch.save has no counterpart). Restore rebuilds each leaf
# with jax.make_array_from_single_device_arrays against the TEMPLATE's
# sharding, so the mesh/partitioning at restore time may differ from save
# time as long as shard boundaries align (same number of shards per leaf,
# matching per-shard shapes).
# ---------------------------------------------------------------------------

def _leaf_key(i: int) -> str:
    return f"leaf{i:05d}"


def save_sharded(directory: str, tree: Any) -> None:
    """Write one .npy per addressable shard plus a manifest. Leaves that
    are not sharded jax.Arrays (numpy, scalars, replicated arrays) are
    pickled whole in the manifest."""
    import pickle

    os.makedirs(directory, exist_ok=True)
    leaves, _ = jax.tree.flatten(tree)
    # structure comes from the restore-side template; storing only leaves
    # keeps the manifest free of treedef pickling pitfalls
    manifest = {"leaves": []}
    for i, leaf in enumerate(leaves):
        is_sharded = (
            isinstance(leaf, jax.Array)
            and hasattr(leaf, "sharding")
            and not leaf.sharding.is_fully_replicated
        )
        if not is_sharded:
            manifest["leaves"].append(("inline", np.asarray(leaf)))
            continue
        entries = []
        for s in leaf.addressable_shards:
            fname = f"{_leaf_key(i)}_d{s.device.id}.npy"
            np.save(os.path.join(directory, fname), np.asarray(s.data))
            # slice indices as (start, stop) per dim; None -> full extent
            idx = tuple(
                (sl.start or 0, sl.stop if sl.stop is not None else dim)
                for sl, dim in zip(s.index, leaf.shape)
            )
            entries.append({"file": fname, "index": idx})
        manifest["leaves"].append(
            ("sharded", {"shape": leaf.shape, "dtype": str(leaf.dtype),
                         "shards": entries})
        )
    with open(os.path.join(directory, "manifest.pkl"), "wb") as f:
        pickle.dump(manifest, f)


def restore_sharded(directory: str, template: Any) -> Any:
    """Rebuild the saved tree. ``template`` supplies the target sharding
    (and device placement) per leaf; sharded leaves are loaded one shard at
    a time directly onto their devices."""
    import pickle

    with open(os.path.join(directory, "manifest.pkl"), "rb") as f:
        manifest = pickle.load(f)
    t_leaves, t_def = jax.tree.flatten(template)
    out = []
    for i, ((kind, payload), t_leaf) in enumerate(
        zip(manifest["leaves"], t_leaves)
    ):
        if kind == "inline":
            out.append(payload)
            continue
        assert isinstance(t_leaf, jax.Array), (
            f"leaf {i} was saved sharded; template must be a jax.Array "
            "carrying the target sharding"
        )
        sharding = t_leaf.sharding
        assert tuple(payload["shape"]) == tuple(t_leaf.shape), (
            payload["shape"], t_leaf.shape,
        )
        # map saved shards by their index box; device_put each piece onto
        # the device the TARGET sharding wants that box on
        by_index = {tuple(e["index"]): e["file"] for e in payload["shards"]}
        pieces = []
        for dev, sl in sharding.addressable_devices_indices_map(
            tuple(payload["shape"])
        ).items():
            idx = tuple(
                (s.start or 0, s.stop if s.stop is not None else dim)
                for s, dim in zip(sl, payload["shape"])
            )
            fname = by_index.get(idx)
            assert fname is not None, (
                f"no saved shard covers {idx}; saved boxes: "
                f"{sorted(by_index)} (re-striping across different shard "
                "boundaries is not supported)"
            )
            arr = np.load(os.path.join(directory, fname))
            pieces.append(jax.device_put(arr, dev))
        out.append(
            jax.make_array_from_single_device_arrays(
                tuple(payload["shape"]), sharding, pieces
            )
        )
    return jax.tree.unflatten(t_def, out)
