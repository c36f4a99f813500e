"""Real multi-process worker for the cross-process collective test.

Launched as ``python multiproc_worker.py <process_id> <num_processes>
<coordinator_port> <out_dir>`` by tests/test_multihost.py. Each process
owns 4 virtual CPU devices; collectives genuinely cross the process
boundary through the distributed runtime (the single-host stand-in for the
multi-host DCN deployment of SURVEY.md §2.12).

Executes, for real (no mocks):
  1. multihost.initialize_distributed  (jax.distributed over localhost)
  2. multihost.global_mesh             (8 devices across 2 processes)
  3. multihost.host_local_batch_to_global + a cross-process psum
  4. ShardedDenseIndex build from per-process corpus slices +
     parallel.collectives.sharded_topk, checked against the local oracle.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port, out_dir = (
    int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sessionsimilaritysearch.parallel import multihost  # noqa: E402

multihost.initialize_distributed(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert jax.process_index() == pid
assert len(jax.devices()) == 4 * nproc, len(jax.devices())
assert len(jax.local_devices()) == 4

mesh = multihost.global_mesh()
assert mesh.devices.size == 4 * nproc

# --- host-local batch -> global array + a collective ACROSS processes ---
n_global = 32
lo, hi = multihost.process_slice(n_global)
assert (hi - lo) == n_global // nproc
full = np.arange(n_global, dtype=np.float32)[:, None] * np.ones(
    (1, 8), np.float32
)
local = full[lo:hi]  # each process contributes only its own rows
gbatch = multihost.host_local_batch_to_global(local, mesh)
assert gbatch.shape == (n_global, 8)

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


@jax.jit
def global_sum(x):
    # reduction over the globally-sharded axis: XLA inserts the
    # cross-process collective (this is the DCN psum in production)
    return jnp.sum(x, dtype=jnp.float32)


total = float(global_sum(gbatch))
expect = float(full.astype(np.float64).sum())
assert total == expect, (total, expect)

# an explicit shard_map psum over the data axis, also cross-process
ones = multihost.host_local_batch_to_global(
    np.ones((4 * nproc // nproc,), np.float32) * (pid + 1), mesh
)
psummed = jax.jit(
    jax.shard_map(
        lambda x: jax.lax.psum(jnp.sum(x), "data"),
        mesh=mesh,
        in_specs=P("data"),
        out_specs=P(),
    )
)(ones)
expect_psum = sum(4 * (p + 1) for p in range(nproc))
assert float(psummed) == expect_psum, (float(psummed), expect_psum)

# --- sharded retrieval across the process boundary ---
from sessionsimilaritysearch.index.sharded import ShardedDenseIndex  # noqa: E402
from sessionsimilaritysearch.ops.topk import oracle_topk_np  # noqa: E402

rng = np.random.default_rng(7)  # same corpus on every process (oracle)
corpus = rng.standard_normal((256, 16)).astype(np.float32)
queries = rng.standard_normal((8, 16)).astype(np.float32)

index = ShardedDenseIndex(
    dim=16, capacity=256, mesh=mesh, metric="ip", chunk_size=32
)
index.add(corpus)  # device_put with a global NamedSharding distributes rows
D, I = index.search(queries, 5)
ovals, oidx = oracle_topk_np(queries, corpus, 5, metric="ip")
np.testing.assert_allclose(D, ovals, rtol=1e-4, atol=1e-5)
# exact engine on well-separated random data: index sets match
np.testing.assert_array_equal(np.sort(I, 1), np.sort(oidx, 1))

with open(os.path.join(out_dir, f"ok_{pid}"), "w") as f:
    f.write(
        f"process {pid}/{nproc}: devices={len(jax.devices())} "
        f"psum={float(psummed)} topk_ok\n"
    )
print(f"WORKER_{pid}_OK", flush=True)
