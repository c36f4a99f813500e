"""Mixed-workload serving soak, tiny.

Drives the real examples/serving_soak.py loop — ingest / search /
remove_sessions / expire / snapshot+restore interleaved — and asserts the
operator-facing invariants: zero jit-cache growth across the whole mixed
phase (the no-retrace contract under realistic load, including after a
snapshot-restore), identical search results across restore, and consistent
row accounting. Counterpart capability: the reference serves from
build-once indexes with no maintenance loop (test_amazon_filterd.py:207-223).
"""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from examples.serving_soak import run_soak  # noqa: E402


@pytest.fixture(scope="module")
def soak_report(tmp_path_factory):
    args = types.SimpleNamespace(
        rows=512, asin_num=None, fill_chunk=128, batches=6, qbatch=32,
        ibatch=32, k=10, embed_batch=32, remove_every=2, expire_every=3,
        workdir=str(tmp_path_factory.mktemp("soak")), tiny=True,
        platform=None, out=None,
    )
    # tiny=True overrides sizes inside run_soak; pin the smaller ones back
    report = run_soak(args)
    return report, args


class TestServingSoak:
    def test_jit_cache_flat(self, soak_report):
        report, _ = soak_report
        assert report["jit_cache_flat"], (
            f"jit cache grew during the mixed phase: "
            f"{report['jit_cache_after_warmup']} -> "
            f"{report['jit_cache_end']}"
        )

    def test_snapshot_restore_parity(self, soak_report):
        report, _ = soak_report
        assert report["snapshot"] is not None
        assert report["snapshot"]["search_identical_after_restore"]
        # non-blocking save: the snapshot result must reflect the CAPTURE
        # point even though serving kept mutating the corpus during the
        # background write (save_async consistency contract)
        assert report["snapshot"]["save_s"] is not None

    def test_maintenance_verbs_ran(self, soak_report):
        report, _ = soak_report
        assert report["removed_rows"] > 0
        assert report["expired_rows"] > 0
        # the snapshot is non-blocking now: only the capture+dispatch cost
        # lands in the serving loop (the write streams on a worker thread)
        assert set(report["ops_ms"]) >= {"ingest", "remove",
                                         "snapshot_capture"}

    def test_row_accounting(self, soak_report):
        report, args = soak_report
        # fill + streamed - removed - expired ~= ntotal; content-keyed
        # warmup removal can also sweep bulk rows whose session content
        # duplicates a victim's (the generator draws with replacement), so
        # allow a small slack instead of exact equality
        expected = (report["rows"] + report["mixed_batches"] * 64
                    - report["removed_rows"] - report["expired_rows"])
        assert abs(report["ntotal_end"] - expected) <= 16
        assert report["engine_stats"]["pending"] == 0


@pytest.fixture(scope="module")
def sharded_soak_report(tmp_path_factory):
    """The same mixed verb load against a ShardedDenseIndex engine over
    the 8-device virtual mesh: stable gids, tombstoned
    metadata, collective search, snapshot under load."""
    args = types.SimpleNamespace(
        rows=512, asin_num=None, fill_chunk=128, batches=6, qbatch=32,
        ibatch=32, k=10, embed_batch=32, remove_every=2, expire_every=3,
        workdir=str(tmp_path_factory.mktemp("soak8")), tiny=True,
        platform=None, out=None, mesh=8,
    )
    return run_soak(args), args


class TestShardedServingSoak:
    def test_jit_cache_flat(self, sharded_soak_report):
        report, _ = sharded_soak_report
        assert report["mesh_devices"] == 8
        assert report["jit_cache_flat"], (
            f"sharded serving retraced during the mixed phase: "
            f"{report['jit_cache_after_warmup']} -> "
            f"{report['jit_cache_end']}"
        )

    def test_snapshot_restore_parity(self, sharded_soak_report):
        report, _ = sharded_soak_report
        assert report["snapshot"] is not None
        assert report["snapshot"]["search_identical_after_restore"]

    def test_maintenance_verbs_ran(self, sharded_soak_report):
        report, _ = sharded_soak_report
        assert report["removed_rows"] > 0
        assert report["expired_rows"] > 0
        assert set(report["ops_ms"]) >= {"ingest", "remove",
                                         "snapshot_capture"}
        assert report["engine_stats"]["pending"] == 0
