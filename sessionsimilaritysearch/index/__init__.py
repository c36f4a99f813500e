from sessionsimilaritysearch.index.dense import DenseIndex, build_index  # noqa: F401
from sessionsimilaritysearch.index.binary import BinaryIndex  # noqa: F401
from sessionsimilaritysearch.index.sharded import ShardedDenseIndex  # noqa: F401
from sessionsimilaritysearch.index.sharded_binary import (  # noqa: F401
    ShardedBinaryIndex,
)
from sessionsimilaritysearch.index.twostage import (  # noqa: F401
    ShardedTwoStageIndex,
    TwoStageIndex,
    build_twostage_index,
)
