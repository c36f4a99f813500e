from sessionsimilaritysearch.data.schema import (  # noqa: F401
    Action,
    get_all_query,
    get_item,
    get_item_pos_cnt,
    get_item_title,
    get_item_type,
    get_next_query,
    get_query,
    get_session_item_title,
    session_to_text,
)
from sessionsimilaritysearch.data.graph import (  # noqa: F401
    SessionGraph,
    batch_graphs,
    build_graph_batch,
    sequence_to_graph,
)
from sessionsimilaritysearch.data.synthetic import (  # noqa: F401
    AdversarialSessionGenerator,
    SyntheticSessionGenerator,
)
from sessionsimilaritysearch.data.similarity import (  # noqa: F401
    get_ave_score,
    get_score,
)
