"""parallel/multihost.py coverage: the single-process no-op path, the
process-slice arithmetic, and host-local -> global batch assembly on a
1-process (8-virtual-device) mesh. The multi-process branches can't execute
in a single-host environment; everything that CAN run here is pinned
"""

import jax
import numpy as np
import pytest

from sessionsimilaritysearch.parallel import multihost


class TestInitializeDistributed:
    def test_single_process_is_noop(self):
        # must not raise and must not touch jax.distributed
        multihost.initialize_distributed()
        multihost.initialize_distributed(num_processes=1, process_id=0)
        multihost.initialize_distributed(num_processes=None)

    def test_multi_process_requires_coordinator(self, monkeypatch):
        calls = {}

        def fake_init(**kw):
            calls.update(kw)

        monkeypatch.setattr(jax.distributed, "initialize", fake_init)
        multihost.initialize_distributed(
            coordinator_address="host0:1234", num_processes=4, process_id=2
        )
        assert calls == {
            "coordinator_address": "host0:1234",
            "num_processes": 4,
            "process_id": 2,
        }


class TestGlobalMesh:
    def test_default_covers_all_devices(self):
        mesh = multihost.global_mesh()
        assert mesh.devices.size == len(jax.devices())
        assert mesh.axis_names == ("data",)

    def test_explicit_shape(self):
        n = len(jax.devices())
        if n % 2:
            pytest.skip("needs an even device count")
        mesh = multihost.global_mesh(
            axis_names=("data", "model"), shape=(n // 2, 2)
        )
        assert mesh.shape == {"data": n // 2, "model": 2}


class TestProcessSlice:
    def test_single_process_full_range(self):
        assert multihost.process_slice(17) == (0, 17)
        assert multihost.process_slice(0) == (0, 0)

    def test_multi_process_arithmetic(self, monkeypatch):
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        for pid, want in [(0, (0, 4)), (1, (4, 8)), (2, (8, 12)),
                          (3, (12, 18))]:
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            # last process absorbs the remainder
            assert multihost.process_slice(18) == want

    def test_slices_cover_without_overlap(self, monkeypatch):
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        spans = []
        for pid in range(3):
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            spans.append(multihost.process_slice(10))
        assert spans[0][0] == 0 and spans[-1][1] == 10
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 == b0


class TestHostLocalBatchToGlobal:
    def test_roundtrip_on_single_process_mesh(self):
        mesh = multihost.global_mesh()
        n = mesh.devices.size
        batch = {
            "x": np.arange(4 * n * 3, dtype=np.float32).reshape(4 * n, 3),
            "y": np.arange(4 * n, dtype=np.int32),
        }
        out = multihost.host_local_batch_to_global(batch, mesh)
        assert out["x"].shape == (4 * n, 3)
        assert out["x"].sharding.is_fully_addressable
        np.testing.assert_array_equal(np.asarray(out["x"]), batch["x"])
        np.testing.assert_array_equal(np.asarray(out["y"]), batch["y"])
        # leading axis is sharded over 'data': each device holds 4 rows
        shard_rows = {
            s.data.shape[0] for s in out["x"].addressable_shards
        }
        assert shard_rows == {4}

    def test_global_array_feeds_jit(self):
        mesh = multihost.global_mesh()
        n = mesh.devices.size
        x = np.ones((2 * n, 5), dtype=np.float32)
        gx = multihost.host_local_batch_to_global(x, mesh)
        s = jax.jit(lambda a: a.sum())(gx)
        assert float(s) == 10.0 * n


class TestRealMultiProcess:
    """Collectives must actually cross a process
    boundary. Two REAL subprocesses (4 virtual CPU devices each) form one
    jax.distributed job over a localhost coordinator (Gloo); each executes
    initialize_distributed, global_mesh over all 8 devices,
    host_local_batch_to_global, a cross-process psum, and a
    ShardedDenseIndex sharded_topk checked against the oracle
    (tests/multiproc_worker.py -- a real file because spawned interpreters
    must import it)."""

    def test_two_process_collectives_and_sharded_search(self, tmp_path):
        import socket
        import subprocess
        import sys
        import os as _os

        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        worker = _os.path.join(_os.path.dirname(__file__), "multiproc_worker.py")
        env = {
            k: v for k, v in _os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
        }
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port), str(tmp_path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for i in range(2)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=300)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
            assert f"WORKER_{i}_OK" in out
            assert (tmp_path / f"ok_{i}").exists()
        # the workers really formed ONE job: Gloo connected peer ranks
        assert any("connected" in o for o in outs)
