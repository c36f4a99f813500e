"""Parameter sharding rules.

Default layout: replicate everything except the wide embedding tables (the
asin vocabulary at reference scale is 391,572 rows --
pretrain_filtered_amazon.py:200 -- the one genuinely large parameter), which
shard row-wise over the mesh. XLA/GSPMD then turns the [B, d] x [d, A]
logit matmuls of the asin losses into per-shard partials with the right
collectives (SURVEY.md §7 hard part (b))."""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _spec_for(path_names, leaf, mesh: Mesh, shard_axis: str, min_rows: int):
    is_embedding = any("embedding" in n.lower() for n in path_names) or any(
        "asin" in n.lower() for n in path_names
    )
    if (
        is_embedding
        and hasattr(leaf, "ndim")
        and leaf.ndim == 2
        and leaf.shape[0] >= min_rows
        and leaf.shape[0] % mesh.shape[shard_axis] == 0
    ):
        return P(shard_axis, None)
    return P()


def param_shardings(
    params: Any,
    mesh: Mesh,
    shard_axis: str = "data",
    min_rows: int = 8192,
):
    """A NamedSharding pytree matching ``params``: big embedding tables
    sharded row-wise, everything else replicated."""

    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    specs = []
    for path, leaf in flat:
        names = [
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path
        ]
        specs.append(
            NamedSharding(mesh, _spec_for(names, leaf, mesh, shard_axis, min_rows))
        )
    return jax.tree_util.tree_unflatten(treedef, specs)


def shard_params(params, mesh: Mesh, **kw):
    sh = param_shardings(params, mesh, **kw)
    return jax.tree.map(jax.device_put, params, sh)
