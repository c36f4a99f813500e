"""Native C++ library tests: parity with the pure-Python implementations
and the numpy oracle. Skipped when the toolchain can't build the .so."""

import numpy as np
import pytest

from sessionsimilaritysearch import native
from sessionsimilaritysearch.data import levenshtein
from sessionsimilaritysearch.ops.topk import oracle_topk_np
from sessionsimilaritysearch.tokenizer import HashTokenizer

lib_available = native.load() is not None
pytestmark = pytest.mark.skipif(
    not lib_available, reason="native library unavailable"
)


class TestNativeLevenshtein:
    CASES = [
        ("abc", "abc"), ("", ""), ("abc", "xyz"), ("abcd", "abed"),
        ("red lamp", "red lamps"), ("a", "ab"), ("kitten", "sitting"),
    ]

    def test_ratio_matches_python(self):
        for a, b in self.CASES:
            want = (
                (len(a) + len(b) - levenshtein._indel_distance(a, b))
                / (len(a) + len(b))
                if (a or b)
                else 1.0
            )
            got = native.ratio(a, b)
            assert abs(got - want) < 1e-12, (a, b)

    def test_seqratio_matches_python_dp(self):
        seqs = [
            (["red lamp"], ["red lamp", "blue lamp"]),
            (["a", "b"], ["a", "b"]),
            (["abc"], ["xyz"]),
            (["one", "two", "three"], ["one", "three"]),
        ]
        for a, b in seqs:
            # recompute the pure-python DP inline (ratio via python impl)
            lensum = len(a) + len(b)
            prev = [float(j) for j in range(len(b) + 1)]
            for i in range(1, len(a) + 1):
                cur = [float(i)] + [0.0] * len(b)
                for j in range(1, len(b) + 1):
                    aa, bb = a[i - 1], b[j - 1]
                    r = (
                        (len(aa) + len(bb) - levenshtein._indel_distance(aa, bb))
                        / (len(aa) + len(bb))
                        if (aa or bb)
                        else 1.0
                    )
                    sub = prev[j - 1] + 2.0 * (1.0 - r)
                    cur[j] = min(prev[j] + 1.0, cur[j - 1] + 1.0, sub)
                prev = cur
            want = (lensum - prev[len(b)]) / lensum
            got = native.seqratio(a, b)
            assert abs(got - want) < 1e-12, (a, b)

    def test_string_match(self):
        got = native.string_match(["red lamp", "zzz"], ["red lamp", "red lamps"])
        assert got == (1, 2)


class TestNativeTokenizer:
    def test_matches_python_tokenizer(self):
        tok = HashTokenizer(vocab_size=5000)
        texts = [
            "hello world", "", "Wireless KEYBOARD 42", "a b c d e f g h i j k",
            "unicode café test", "x" * 200,
        ]
        native_ids = native.tokenize_batch(texts, 12, 5000)
        py_ids = np.stack([tok.encode_one(t, 12) for t in texts])
        np.testing.assert_array_equal(native_ids, py_ids)

    def test_non_ascii_case_folding(self):
        """Unicode chars whose lowercase maps into ASCII (U+212A KELVIN
        SIGN -> 'k', U+0130 -> 'i' + combining dot) must tokenize
        identically to HashTokenizer's str.lower() path."""
        tok = HashTokenizer(vocab_size=5000)
        texts = [
            "\u212aelvin scale",          # KELVIN SIGN folds to ascii k
            "\u0130stanbul lamp",         # dotted capital I
            "stra\u00dfe 42",             # sharp s folds to 'ss'
            "caf\u00e9 NOIR",             # e-acute stays non-ascii
        ]
        native_ids = native.tokenize_batch(texts, 12, 5000)
        py_ids = np.stack([tok.encode_one(t, 12) for t in texts])
        np.testing.assert_array_equal(native_ids, py_ids)

    def test_wired_into_hash_tokenizer(self):
        tok = HashTokenizer(vocab_size=5000)
        out = tok(["red lamp", None], max_length=8)
        assert out["input_ids"].shape == (2, 8)
        assert out["attention_mask"][1].sum() == 2  # CLS + SEP for None


class TestNativeOracle:
    def test_topk_matches_numpy(self, rng):
        corpus = rng.standard_normal((500, 32)).astype(np.float32)
        queries = rng.standard_normal((7, 32)).astype(np.float32)
        nv, ni = native.topk_oracle(corpus, queries, 5)
        ov, oi = oracle_topk_np(queries, corpus, 5)
        np.testing.assert_allclose(nv, ov, rtol=1e-5)
        np.testing.assert_array_equal(ni, oi)


class TestNativeGraphBuilder:
    """Bit-exactness of the C++ whole-batch builder (graph_builder.cpp)
    against the Python reference path sequence_to_graph + batch_graphs."""

    @staticmethod
    def _edge_sessions():
        from sessionsimilaritysearch.data.schema import Action

        def S(kw=None):
            return Action(0.0, "s", kw, None, None, None, None, 0)

        def C(aid, title="", kind="c"):
            return Action(0.0, kind, None, f"A{aid}", "t", "b", title, aid)

        return [
            ([], []),                                 # empty prefix + future
            ([S("hello")], []),                       # searches only
            ([S(None), S("")], [S(None)]),            # None keywords
            ([C(5, None)], []),                       # None title
            ([C(1, "x"), C(1, "y"), C(1, "x")], []),  # repeats, title drift
            ([C(i % 3, f"t{i}") for i in range(30)], []),  # > max_seq_len
            ([S("a")] * 25 + [C(2, "z")], []),        # > Q search actions
            ([C(1, "p1"), S("q"), C(2, "p2", "ca"), C(1, "p1"),
              C(3, "p3", "p")],
             [C(9, "f9", "p"), S("fq"), C(9, "f9"), C(8, None, "ca"),
              S(None)]),
            ([S("q1"), C(4, "AbC-123! x")], [S("only future query")]),
            ([C(7, "seven")], [C(7, "seven2")]),
        ]

    @pytest.mark.parametrize("ignore_query", [False, True])
    def test_matches_python_builder(self, ignore_query):
        from sessionsimilaritysearch.config import tiny_test_config
        from sessionsimilaritysearch.data import (
            SessionGraph,
            SyntheticSessionGenerator,
            batch_graphs,
            build_graph_batch,
            sequence_to_graph,
        )
        from sessionsimilaritysearch.tokenizer import get_tokenizer

        cfg = tiny_test_config()
        tok = get_tokenizer(cfg.vocab_size)
        gen = SyntheticSessionGenerator(asin_num=200, seed=9)
        data = self._edge_sessions() + gen.dataset(40)
        idxs = list(range(100, 100 + len(data)))
        nat = build_graph_batch(
            data, tok, cfg.dims, indices=idxs, ignore_query=ignore_query
        )
        ref = batch_graphs([
            sequence_to_graph(i, s, t, tok, cfg.dims,
                              ignore_query=ignore_query)
            for i, (s, t) in zip(idxs, data)
        ])
        for name, a, b in zip(SessionGraph._fields, nat, ref):
            assert a.dtype == b.dtype, name
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


class TestBuild:
    SOURCES = ("Makefile", "levenshtein.cpp", "graph_builder.cpp",
               "tokenize_inl.h")

    def test_builds_without_openmp(self, tmp_path):
        """A compiler that rejects -fopenmp (a toolchain without libgomp)
        still builds the library, serial."""
        import ctypes
        import os
        import shutil
        import subprocess

        if shutil.which("make") is None or shutil.which("g++") is None:
            pytest.skip("needs make and g++")
        src = os.path.dirname(native.__file__)
        for f in self.SOURCES:
            shutil.copy(os.path.join(src, f), tmp_path)
        fake = tmp_path / "gxx"
        fake.write_text('#!/bin/sh\nfor a in "$@"; do\n'
                        '  [ "$a" = "-fopenmp" ] && exit 1\ndone\n'
                        'exec g++ "$@"\n')
        fake.chmod(0o755)
        proc = subprocess.run(["make", "-C", str(tmp_path), f"CXX={fake}"],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "-fopenmp" not in proc.stdout
        lib = ctypes.CDLL(str(tmp_path / "libsss_native.so"))
        assert hasattr(lib, "build_graph_batch")

    def test_failed_build_warns(self, tmp_path, monkeypatch):
        (tmp_path / "Makefile").write_text(
            "libsss_native.so:\n\t@echo no compiler here >&2; exit 1\n")
        monkeypatch.setattr(native, "_HERE", str(tmp_path))
        monkeypatch.setattr(native, "_SO", str(tmp_path / "libsss_native.so"))
        with pytest.warns(RuntimeWarning, match="no compiler here"):
            assert native._build() is False
