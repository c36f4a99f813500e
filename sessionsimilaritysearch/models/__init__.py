from sessionsimilaritysearch.models.embedding import (  # noqa: F401
    NodeAsinEmbedding,
    NodeTextTransformer,
    TextEncoder,
)
from sessionsimilaritysearch.models.gnn import (  # noqa: F401
    HGT,
    DenseGATConv,
    DenseGatedGraphConv,
    DenseGCNConv,
    DenseSAGEConv,
    HeteroGGNN,
    HeteroSAGE,
)
from sessionsimilaritysearch.models.pooling import (  # noqa: F401
    AttentionPooling,
    GraphPooling,
    PositionalAttentionPooling,
    SRGNNPooling,
)
from sessionsimilaritysearch.models.heads import (  # noqa: F401
    MLP,
    BinarizeHead,
    CrossAttentionTransformer,
    TransformerDecoderHead,
)
from sessionsimilaritysearch.models.encoder import (  # noqa: F401
    GraphLevelEncoder,
    NodeLevelEncoder,
    TextSessionEncoder,
    UnifyPoolingGraphLevelEncoder,
    build_graph_encoder,
    build_pretrain_encoder,
    build_text_backbone,
    build_text_session_encoder,
)
