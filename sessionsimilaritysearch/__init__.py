"""Session-similarity index-and-query engine in JAX.

A from-scratch JAX / XLA re-design of the capabilities of
ZongyueQin/SessionSimilaritySearch (see SURVEY.md): e-commerce sessions are
turned into heterogeneous query-product graphs, encoded with GNN / text
encoders into fixed-length (optionally binarized) session embeddings, and
served by exact top-k search over an L2-normalized embedding corpus sharded
across a device mesh.

Layer map:

- ``config``    -- dataclass config registry (reference: config.py)
- ``tokenizer`` -- host-side offline tokenizer (reference: HF BertTokenizer)
- ``data``      -- session schema, padded dense graph transform, synthetic
                   generator, similarity labelers (reference:
                   util_amazon_filtered.py, decompose_data.py, DataLoader.py)
- ``nn``        -- the small module layer the models are written in
- ``models``    -- encoder zoo on dense padded graphs (reference: model/)
- ``ops``       -- XLA scans: blocked MIPS top-k, Hamming search
- ``index``     -- the sharded dense / binary index (reference: FAISS flat)
- ``parallel``  -- mesh, shardings, cross-shard top-k merge
- ``training``  -- pretrain / session / subsession / fine-tune drivers
                   (reference: pretrain_filtered_amazon.py, train_*.py,
                   fine_tune_{ours,QAEA}.py)
- ``evalharness`` -- retrieval metric suite + end-to-end benchmark driver
                   (reference: test_amazon_filterd.py)
"""

__version__ = "0.1.0"

from sessionsimilaritysearch.config import Config  # noqa: F401
