from sessionsimilaritysearch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    replicated,
    shard_batch,
)
from sessionsimilaritysearch.parallel.sharding import (  # noqa: F401
    param_shardings,
    shard_params,
)
