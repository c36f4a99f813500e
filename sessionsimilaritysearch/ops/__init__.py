from sessionsimilaritysearch.ops.topk import (  # noqa: F401
    chunked_topk,
    exact_topk,
    l2_normalize,
    merge_topk,
    oracle_topk_np,
    recall_at_k,
    value_recall_at_k,
)
from sessionsimilaritysearch.ops.hamming import (  # noqa: F401
    hamming_topk,
    pack_bits_np,
    sign_topk,
)
from sessionsimilaritysearch.ops.projection import (  # noqa: F401
    PCAProjector,
    fit_pca,
)
