"""Unit tests for the data layer: tokenizer, schema accessors, graph
transform parity with the reference semantics (SURVEY.md §2.3), similarity
labelers, synthetic generator."""

import numpy as np
import pytest

from sessionsimilaritysearch.config import tiny_test_config
from sessionsimilaritysearch.data import schema
from sessionsimilaritysearch.data.graph import (
    batch_graphs,
    sequence_to_graph,
    truncate_to_subsession,
)
from sessionsimilaritysearch.data import levenshtein, similarity
from sessionsimilaritysearch.tokenizer import (
    CLS_ID,
    HashTokenizer,
    NUM_SPECIAL,
    PAD_ID,
    SEP_ID,
)


def _mk_session():
    """Hand-built session: search, click a, click b, search, click a."""
    A = schema.Action
    return [
        A(0.0, "s", "red lamp", None, None, None, None),
        A(1.0, "c", None, "A7", "lamps", "acme", "red lamp deluxe", 7),
        A(2.0, "c", None, "A9", "lamps", "acme", "blue lamp", 9),
        A(3.0, "s", "blue lamp", None, None, None, None),
        A(4.0, "ca", None, "A7", "lamps", "acme", "red lamp deluxe", 7),
    ]


class TestTokenizer:
    def test_shapes_and_masks(self):
        tok = HashTokenizer(vocab_size=1000)
        out = tok(["hello world", ""], max_length=8)
        assert out["input_ids"].shape == (2, 8)
        assert out["input_ids"][0, 0] == CLS_ID
        assert out["input_ids"][1, 0] == CLS_ID
        assert out["input_ids"][1, 1] == SEP_ID
        assert out["attention_mask"][1].sum() == 2
        # word ids land in the maskable range (>= 5), matching the
        # reference's MLM maskability rule (pretrain_filtered_amazon.py:34)
        assert out["input_ids"][0, 1] >= NUM_SPECIAL

    def test_deterministic(self):
        t1, t2 = HashTokenizer(1000), HashTokenizer(1000)
        a = t1(["wireless keyboard"], max_length=10)["input_ids"]
        b = t2(["wireless keyboard"], max_length=10)["input_ids"]
        np.testing.assert_array_equal(a, b)

    def test_truncation(self):
        tok = HashTokenizer(1000)
        out = tok(["a b c d e f g h i j"], max_length=5)
        assert out["input_ids"].shape == (1, 5)
        assert out["input_ids"][0, -1] == SEP_ID


class TestSchema:
    def test_accessors(self):
        s = _mk_session()
        assert schema.get_item(s) == {7, 9}
        assert schema.get_all_query(s) == ["red lamp", "blue lamp"]
        assert schema.get_next_query(s) == "red lamp"
        assert schema.get_item_type(s) == ["lamps", "lamps", "lamps"]
        assert schema.get_session_item_title(s) == [
            "red lamp deluxe",
            "blue lamp",
            "red lamp deluxe",
        ]
        assert schema.get_query(s) == ["", "red lamp", "blue lamp"]
        assert schema.get_query(s, pad=False) == ["red lamp", "blue lamp"]

    def test_item_pos_cnt(self):
        s = _mk_session()
        items = [7, 9]
        pos, cnt = schema.get_item_pos_cnt(s, items)
        # item 7 occurs at indices 1 and 4 -> reverse pos 4, 1; item 9 at 2 -> 3
        assert cnt == [2, 1]
        assert pos == [4, 1, 3]

    def test_session_to_text(self):
        s = _mk_session()
        txt = schema.session_to_text(s)
        assert txt[0] == "red lamp"
        assert txt[1] == "red lamp deluxe"


class TestGraph:
    @pytest.fixture(scope="class")
    def graph(self):
        cfg = tiny_test_config()
        tok = HashTokenizer(cfg.vocab_size)
        s = _mk_session()
        tar = [
            schema.Action(5.0, "s", "lamp shade", None, None, None, None),
            schema.Action(6.0, "c", None, "A11", "shades", "b", "lamp shade x", 11),
        ]
        return sequence_to_graph(3, s, tar, tok, cfg.dims), cfg.dims

    def test_query_nodes(self, graph):
        g, dims = graph
        # root + 2 searches
        assert g.query_node_mask.sum() == 3
        assert g.query_loss_mask[0] == 0  # root excluded (ref :110)
        assert g.query_loss_mask.sum() == 2
        # reverse positions: n=5; root pos 0 -> 5; searches at i=0,3 -> 4, 1
        np.testing.assert_array_equal(g.query_pos[:3], [5, 4, 1])

    def test_product_nodes(self, graph):
        g, _ = graph
        assert g.product_node_mask.sum() == 2
        np.testing.assert_array_equal(g.product_asin[:2], [7, 9])
        np.testing.assert_array_equal(g.product_cnt[:2], [2, 1])

    def test_edges(self, graph):
        g, _ = graph
        # query1 (first search) clicks items 7,9; query2 clicks 7
        assert g.adj_qp[1, 0] == 1  # q1 -> product 7
        assert g.adj_qp[1, 1] == 1  # q1 -> product 9
        assert g.adj_qp[2, 0] == 1  # q2 -> product 7
        assert g.adj_qp.sum() == 3
        # item_seq = [7, 9, 7]: transitions 7->9, 9->7
        assert g.adj_pp[0, 1] == 1
        assert g.adj_pp[1, 0] == 1
        assert g.adj_pp.sum() == 2
        # last transition target is product 7 (row 0)
        np.testing.assert_array_equal(
            g.last_click_mask[:2].astype(int), [1, 0]
        )

    def test_occurrences(self, graph):
        g, _ = graph
        assert g.occ_mask.sum() == 3
        np.testing.assert_array_equal(g.occ_product[:3], [0, 0, 1])
        np.testing.assert_array_equal(g.occ_pos[:3], [4, 1, 3])

    def test_targets(self, graph):
        g, _ = graph
        assert g.product_target_mask.sum() == 1
        assert g.product_target_y[0] == 11
        assert g.query_target_mask.sum() == 1  # one future query
        assert g.query_target_node_mask.sum() == 1

    def test_empty_target_query_placeholder(self):
        cfg = tiny_test_config()
        tok = HashTokenizer(cfg.vocab_size)
        g = sequence_to_graph(0, _mk_session(), [], tok, cfg.dims)
        # masked '' placeholder (ref util_amazon_filtered.py:114-119)
        assert g.query_target_node_mask.sum() == 1
        assert g.query_target_mask.sum() == 0

    def test_ignore_query(self):
        cfg = tiny_test_config()
        tok = HashTokenizer(cfg.vocab_size)
        g = sequence_to_graph(0, _mk_session(), [], tok, cfg.dims, ignore_query=True)
        assert g.query_node_mask.sum() == 1  # only root remains
        assert g.adj_qp.sum() == 3  # all clicks attach to root
        assert g.adj_qp[0].sum() == 3

    def test_empty_product_placeholder(self):
        cfg = tiny_test_config()
        tok = HashTokenizer(cfg.vocab_size)
        s = [schema.Action(0.0, "s", "query only", None, None, None, None)]
        g = sequence_to_graph(0, s, [], tok, cfg.dims)
        # unknown-product placeholder (ref :132-135)
        assert g.product_node_mask.sum() == 1
        assert g.product_asin[0] == 0
        assert g.product_cnt[0] == 1

    def test_batching(self, graph):
        g, _ = graph
        b = batch_graphs([g, g, g])
        assert b.query_input_ids.shape[0] == 3
        assert b.adj_pp.shape[0] == 3
        np.testing.assert_array_equal(b.idx, [3, 3, 3])

    def test_truncate_to_subsession(self):
        rng = np.random.default_rng(0)
        s = _mk_session()
        prefix, future = truncate_to_subsession((s, []), rng)
        assert len(prefix) + len(future) == len(s)
        assert any(a[1] != "s" for a in prefix)


class TestLevenshtein:
    def test_ratio(self):
        assert levenshtein.ratio("abc", "abc") == 1.0
        assert levenshtein.ratio("", "") == 1.0
        assert levenshtein.ratio("abc", "xyz") == 0.0
        # indel distance: 'abcd' vs 'abed': LCS=3 -> D2=2 -> (8-2)/8
        assert abs(levenshtein.ratio("abcd", "abed") - 0.75) < 1e-9

    def test_seqratio(self):
        assert levenshtein.seqratio(["a", "b"], ["a", "b"]) == 1.0
        assert levenshtein.seqratio([], []) == 1.0
        assert levenshtein.seqratio(["abc"], ["xyz"]) == 0.0
        r = levenshtein.seqratio(["red lamp"], ["red lamp", "blue lamp"])
        assert 0.0 < r < 1.0

    def test_get_string_match(self):
        a_n, b_n = levenshtein.get_string_match(
            ["red lamp", "zzz"], ["red lamp", "red lamps"]
        )
        assert a_n == 1 and b_n == 2


class TestSimilarity:
    def test_all_types_run(self, gen):
        a, b = gen.datum(), gen.datum()
        for st in similarity.SIM_TYPES:
            s = similarity.get_score(a, b, st)
            assert 0.0 <= s <= 1.0 + 1e-9

    def test_self_similarity(self, gen):
        a = gen.datum()
        assert similarity.get_score(a, a, "all_jaccard") == 1.0
        assert similarity.get_score(a, a, "all_product_type_score") > 0.99

    def test_product_type_score_matches_cosine(self):
        A = schema.Action
        a = ([A(0, "c", None, "A1", "t1", None, "x", 1)], [])
        b = ([A(0, "c", None, "A2", "t1", None, "y", 2), A(1, "c", None, "A3", "t2", None, "z", 3)], [])
        s = similarity.get_score(a, b, "all_product_type_score")
        assert abs(s - 1 / np.sqrt(2)) < 1e-6

    def test_ave_score(self, gen):
        test_data = gen.dataset(3)
        train_sessions = [gen.session() for _ in range(5)]
        I = np.array([[0, 1], [2, 3], [4, 0]])
        s = similarity.get_ave_score(I, test_data, train_sessions, "all_jaccard")
        assert 0.0 <= s <= 1.0

    def test_unknown_type_raises(self, gen):
        with pytest.raises(ValueError):
            similarity.get_score(gen.datum(), gen.datum(), "nope")


class TestSynthetic:
    def test_schema_conformance(self, gen):
        s = gen.session()
        assert 1 <= len(s) <= 21
        for a in s:
            assert a.action_type in ("s", "c", "ca", "p")
            if a.action_type == "s":
                assert a.keyword is not None
            else:
                assert isinstance(a.asin_id, int)
                assert a.title is not None
        assert len(schema.get_item(s)) >= 1

    def test_clustered_similarity_signal(self):
        from sessionsimilaritysearch.data.synthetic import (
            SyntheticSessionGenerator,
        )

        g = SyntheticSessionGenerator(asin_num=500, n_types=5, seed=1)
        data = g.dataset(40)
        mat = similarity.score_matrix(data[:10], "all_product_type_score")
        # diagonal is max, off-diagonal has spread
        assert np.all(np.diag(mat) >= 0.99)
        off = mat[~np.eye(10, dtype=bool)]
        assert off.std() > 0.01


class TestAdversarialSynthetic:
    """The overlap-hostile regime: item overlap must be
    a WEAK similarity signal while the type structure stays intact."""

    @pytest.fixture(scope="class")
    def agen(self):
        from sessionsimilaritysearch.data.synthetic import (
            AdversarialSessionGenerator,
        )

        return AdversarialSessionGenerator(asin_num=2000, seed=3)

    def test_schema_conformance_and_graph_build(self, agen, tokenizer):
        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.data.graph import (
            batch_graphs,
            sequence_to_graph,
        )

        cfg = tiny_test_config(asin_num=2000)
        data = agen.dataset(8)
        for d in data:
            for a in list(d[0]) + list(d[1]):
                assert a.action_type in ("s", "c", "ca", "p")
                if a.action_type != "s":
                    assert isinstance(a.asin_id, int) and a.title
        b = batch_graphs([
            sequence_to_graph(0, *d, tokenizer, cfg.dims) for d in data
        ])
        assert b.product_cnt.shape[0] == 8

    def test_power_law_popularity(self, agen):
        """Click counts concentrate: the head of the distribution is far
        above a uniform draw's."""
        clicks = []
        for _ in range(400):
            clicks += [a.asin_id for a in agen.session()
                       if a.action_type != "s"]
        _, counts = np.unique(clicks, return_counts=True)
        counts = np.sort(counts)[::-1]
        uniform_share = len(clicks) / agen.asin_num
        assert counts[0] > 20 * uniform_share  # trending head dominates

    def test_trending_items_cross_types(self, agen):
        """Trending clicks ignore session interests, so trending items'
        subtypes span many parents -- the spurious-overlap mechanism."""
        tr_types = {int(agen.product_type[a]) for a in agen.trending}
        parents = {int(agen.parent_of[t]) for t in tr_types}
        assert len(parents) >= 3

    def test_sibling_vocab_shared_names_distinct(self, agen):
        """Sibling subtypes share synonym vocabulary (hierarchical text
        structure) but ground-truth type names stay distinct."""
        shared = [
            len(set(agen.syn_pool[t]) & set(agen.syn_pool[t + 1]))
            for t in range(0, agen.n_types - 1, agen.subs_per_parent)
        ]
        assert any(s > 0 for s in shared)
        assert len(set(agen.type_name)) == agen.n_types

    def test_overlap_is_weak_evidence(self, agen):
        """THE regime property: overlap-ranked retrieval (SKNN's mechanism)
        scores far below the type-score oracle, unlike the clustered
        generator where it is near-oracle."""
        from sessionsimilaritysearch.data.similarity import get_score

        corpus = [(agen.session(), []) for _ in range(600)]
        queries = [(agen.session(), []) for _ in range(25)]

        def items(d):
            return frozenset(a.asin_id for a in d[0] if a.action_type != "s")

        ci = [items(c) for c in corpus]
        k = 10
        sknn, oracle = [], []
        for q in queries:
            qi = items(q)
            ov = np.array([
                len(qi & c) / max((len(qi) * len(c)) ** 0.5, 1e-9)
                for c in ci
            ])
            top = np.argsort(-ov)[:k]
            ts = np.array([
                get_score(q, c, "all_product_type_score") for c in corpus
            ])
            sknn.append(ts[top].mean())
            oracle.append(np.sort(ts)[-k:].mean())
        sknn_m, oracle_m = np.mean(sknn), np.mean(oracle)
        assert oracle_m > 0.75  # type structure intact: good neighbors exist
        assert sknn_m < 0.75 * oracle_m  # ...but overlap can't find them
