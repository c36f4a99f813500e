"""Smoke run of the session-search engine on one GPU at reference widths.

Drives the main path once through the entry points a user calls, with
random weights made from ``--seed`` and synthetic sessions:

- device: the card's name and power limit, and the JAX devices; anything
  but a GPU (including a silent CPU fallback) fails the run, and so does a
  host library (``native/``) that did not build.
- serve: a ``SessionSearchEngine`` over a 1,048,576 x 1600 bf16 cosine
  corpus resident on the card, 65,536 rows of it ingested from raw
  sessions through graph build and the flagship ``GraphLevelEncoder``, the
  rest seeded unit rows added through the index. Requests of 256 raw query
  sessions are answered with ``search(k=100)`` and checked against the
  numpy oracle over the whole corpus (value-recall@100 at 2 bf16 ulps).
  The ``int8x8`` dense mode is checked on the same corpus at its
  quantization tolerance (4/127), and ``BinaryIndex`` in its 'sign' and
  'packed' modes over 256-bit SimHash codes of the corpus must return the
  oracle's sorted Hamming distances exactly.
- encoder parity: the encoder on the GPU against the same params on the
  CPU for 64 sessions, both at float32 matmul precision.
- train: pretrain steps at reference dims (batch 256) from a sliced-to-8
  init; losses finite, and a 16-row step on the GPU matches the same step
  on the CPU.

``--four-cards`` runs only the sharded path over four GPUs (corpus
4,194,304 x 1600 bf16, a quarter per card, checked against the oracle,
plus one data-parallel pretrain step with the row-sharded asin table
against the one-device loss).

The last line of standard output is one JSON object with the device; it
is printed only when every phase passed.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # four GPUs of one host
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

EMB_DIM = 1600  # Config().session_emb_dim
CORPUS_ROWS = 1 << 20  # per card: the reference's 1M-session shard
INGEST_ROWS = 1 << 16  # of those, rows ingested from raw sessions
REQUESTS = 3
TRAIN_STEPS = 3
K = 100
REQ = 256  # query sessions per request
ORACLE_Q = 64
BF16_TOL = 2 * 2.0**-8  # two bf16 ulps of the top score
INT8_TOL = 4 / 127  # two-sided int8 quantization step
N_BITS = 256
PARITY_COS = 0.9999  # per-row cosine, GPU vs CPU forward, f32 matmuls
LOSS_RTOL = 1e-3  # GPU vs CPU first-step loss, f32 matmuls


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------
def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    log(f"[device] jax {jax.__version__}: {devs}")
    if platform != "gpu":
        raise SystemExit(
            f"[device] FAIL: expected a GPU, JAX found platform {platform!r}"
        )
    check(len(devs) >= n_cards,
          f"need {n_cards} GPU(s), JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        log(f"[device] {line.strip()}")
    # Graph building and tokenization fall back to Python without the host
    # library, at about half the ingest and request speed: on the card that
    # is a broken build, not a degraded mode.
    from sessionsimilaritysearch import native

    lib = native.load()
    check(lib is not None and hasattr(lib, "build_graph_batch"),
          "native host library did not build or load")
    log(f"[device] native host library: {native._SO}")
    return devs


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def make_encoder(cfg, tok, gen, seed: int):
    """Flagship encoder with random weights, initialised from a sample
    sliced to 8 sessions; returns (module, variables, jitted apply)."""
    import jax

    from sessionsimilaritysearch.data import build_graph_batch
    from sessionsimilaritysearch.models.encoder import build_graph_encoder
    from sessionsimilaritysearch.training.loop import to_device

    enc = build_graph_encoder(cfg)
    sample = to_device(build_graph_batch(gen.dataset(8), tok, cfg.dims))
    variables = jax.jit(enc.init)(jax.random.PRNGKey(seed), sample)
    return enc, variables, jax.jit(enc.apply)


def oracle_topk_chunked(q64: np.ndarray, corpus_host, k: int,
                        chunk: int = 1 << 17):
    """Exact top-k of ``q64 @ corpus.T`` in float64 through
    ``ops.topk.oracle_topk_np``, one corpus chunk at a time (the f64 copy
    of a whole 1M x 1600 corpus would be 13 GB), merged on the host."""
    from sessionsimilaritysearch.ops.topk import oracle_topk_np

    vals, ids = [], []
    for s in range(0, corpus_host.shape[0], chunk):
        c = np.asarray(corpus_host[s: s + chunk], np.float64)
        v, i = oracle_topk_np(q64, c, k)
        vals.append(v.astype(np.float64))
        ids.append(i.astype(np.int64) + s)
    vals, ids = np.concatenate(vals, 1), np.concatenate(ids, 1)
    order = np.argsort(-vals, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def true_scores(q64: np.ndarray, corpus_host, found: np.ndarray):
    """float64 scores of the rows a search returned (-inf for -1 slots)."""
    found = np.asarray(found, np.int64)
    rows = np.asarray(corpus_host[np.maximum(found, 0).ravel()], np.float64)
    rows = rows.reshape(found.shape + (-1,))
    got = np.einsum("qd,qkd->qk", q64, rows)
    return np.where(found >= 0, got, -np.inf)


def value_recall(q64, corpus_host, found, oracle_vals, rel_tol) -> float:
    """ops.topk value-recall matching against the oracle's top-k scores;
    the tolerance is ``rel_tol`` times each query's top score."""
    from sessionsimilaritysearch.ops.topk import value_recall_from_scores

    got = true_scores(q64, corpus_host, found)
    tol = rel_tol * np.abs(oracle_vals[:, 0])
    return value_recall_from_scores(got, oracle_vals, tol)


def hamming_oracle_sorted(q_bits: np.ndarray, c_bits: np.ndarray, k: int,
                          chunk: int = 1 << 16) -> np.ndarray:
    """Sorted k smallest Hamming distances by XOR + popcount of the packed
    codes (numpy, 64-bit words), chunked over the corpus."""
    def words(bits):
        return np.ascontiguousarray(np.packbits(bits, axis=1)).view(np.uint64)

    qw = words(q_bits)
    best = None
    for s in range(0, c_bits.shape[0], chunk):
        x = np.bitwise_xor(qw[:, None, :], words(c_bits[s: s + chunk])[None])
        d = np.bitwise_count(x).sum(axis=2, dtype=np.int32)
        d = np.sort(d, axis=1)[:, :k]
        best = d if best is None else np.sort(
            np.concatenate([best, d], 1), axis=1)[:, :k]
    return best


def unit_rows(key, m: int, dim: int):
    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch.ops.topk import l2_normalize

    return l2_normalize(jax.random.normal(key, (m, dim), jnp.float32))


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def phase_serve(cfg, tok, gen, seed: int):
    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch.engine import SessionSearchEngine
    from sessionsimilaritysearch.index.binary import BinaryIndex
    from sessionsimilaritysearch.index.dense import DenseIndex
    from sessionsimilaritysearch.ops.hamming import simhash_codes
    from sessionsimilaritysearch.ops.topk import l2_normalize

    n, n_ing = CORPUS_ROWS, INGEST_ROWS
    t0 = time.perf_counter()
    enc, variables, apply = make_encoder(cfg, tok, gen, seed)
    encode_fn = lambda g: apply(variables, g)  # noqa: E731
    n_params = sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(variables))
    log(f"[serve] encoder: {n_params} params, out dim "
        f"{cfg.session_emb_dim}, init {time.perf_counter() - t0:.1f}s")
    check(cfg.session_emb_dim == EMB_DIM, "encoder width")

    engine = SessionSearchEngine(
        cfg, tok, encode_fn, dim=EMB_DIM, capacity=n, metric="cos",
        batch_size=256, dtype=jnp.bfloat16,
    )
    sessions = gen.dataset(n_ing)
    t0 = time.perf_counter()
    step = 8192
    for s in range(0, n_ing, step):
        engine.add_sessions(sessions[s: s + step])
    t_ing = time.perf_counter() - t0
    check(engine.index.ntotal == n_ing, "ingested row count")
    log(f"[serve] ingested {n_ing} raw sessions (graph build + encoder + "
        f"insert): {t_ing:.1f}s")
    key = jax.random.PRNGKey(seed + 1)
    t0 = time.perf_counter()
    fill = 1 << 16
    for s in range(n_ing, n, fill):
        key, sub = jax.random.split(key)
        engine.index.add(unit_rows(sub, min(fill, n - s), EMB_DIM))
    jax.block_until_ready(engine.index._buf)
    check(engine.index.ntotal == n, "corpus row count")
    log(f"[serve] corpus {engine.index._buf.shape} "
        f"{engine.index._buf.dtype} on {engine.index._buf.devices()}; "
        f"seeded fill {time.perf_counter() - t0:.1f}s")

    requests = [gen.dataset(REQ) for _ in range(REQUESTS + 1)]
    results = []
    for r, req in enumerate(requests):
        t0 = time.perf_counter()
        D, I = engine.search(req, k=K)
        dt = time.perf_counter() - t0
        check(D.shape == (REQ, K) and I.shape == (REQ, K), "result shape")
        check(bool(np.isfinite(D).all()), "non-finite scores")
        check(bool(((I >= 0) & (I < n)).all()), "ids out of range")
        results.append((D, I))
        what = "first request (compile included)" if r == 0 else "request"
        log(f"[serve] {what} {r}: {REQ} sessions, k={K}: {dt * 1e3:.1f} ms")

    # one request split into its halves: graph build + encoder, then scan
    # + result transfer (each ended on the host)
    req, (D, I) = requests[1], results[1]
    t0 = time.perf_counter()
    q_emb = jax.block_until_ready(engine.embed(req, out="device"))
    t_emb = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.search_embeddings(q_emb, K)
    log(f"[serve] request split: graph build + encode {t_emb * 1e3:.1f} ms, "
        f"scan + transfer {(time.perf_counter() - t0) * 1e3:.1f} ms")

    # oracle over the whole corpus for the first ORACLE_Q queries of that
    # request; queries as the index scores them (normalized bf16)
    q = l2_normalize(jnp.asarray(q_emb, jnp.bfloat16)).astype(jnp.bfloat16)
    q64 = np.asarray(q[:ORACLE_Q], np.float64)
    t0 = time.perf_counter()
    corpus_host = np.asarray(engine.index._buf)  # bf16 rows as stored
    o_vals, _ = oracle_topk_chunked(q64, corpus_host, K)
    log(f"[serve] numpy oracle over {n} rows x {ORACLE_Q} queries: "
        f"{time.perf_counter() - t0:.1f}s")
    rec = value_recall(q64, corpus_host, I[:ORACLE_Q], o_vals, BF16_TOL)
    log(f"[serve] bf16 exact: value-recall@{K} = {rec} "
        f"(rel_tol {BF16_TOL}); top-1 score {float(D[0, 0]):.6f} vs "
        f"oracle {o_vals[0, 0]:.6f}")
    check(rec == 1.0, f"bf16 value-recall@{K} {rec} < 1.0")

    # int8 x int8 dense mode on the same stored rows
    idx8 = DenseIndex(dim=EMB_DIM, capacity=n, metric="cos",
                      quantize="int8x8")
    for s in range(0, n, fill):
        idx8.add(engine.index._buf[s: s + fill])
    t0 = time.perf_counter()
    _, I8 = idx8.search(q[:ORACLE_Q], K)
    t8 = time.perf_counter() - t0
    rec8 = value_recall(q64, corpus_host, I8, o_vals, INT8_TOL)
    log(f"[serve] int8x8: value-recall@{K} = {rec8} (rel_tol {INT8_TOL:.5f})"
        f"; first search {t8 * 1e3:.1f} ms")
    check(rec8 == 1.0, f"int8x8 value-recall@{K} {rec8} < 1.0")
    del idx8

    # binary: 256-bit SimHash codes of the same corpus, sign + packed
    c_codes = simhash_codes(engine.index._buf, N_BITS, seed=seed)
    q_codes = simhash_codes(q[:ORACLE_Q], N_BITS, seed=seed)
    c_bits = np.asarray(c_codes > 0)
    q_bits = np.asarray(q_codes > 0)
    t0 = time.perf_counter()
    want = hamming_oracle_sorted(q_bits, c_bits, K)
    log(f"[serve] numpy Hamming oracle: {time.perf_counter() - t0:.1f}s")
    for mode in ("sign", "packed"):
        bidx = BinaryIndex(n_bits=N_BITS, capacity=n, mode=mode)
        for s in range(0, n, fill):
            bidx.add(c_codes[s: s + fill])
        t0 = time.perf_counter()
        bd, bi = bidx.search(q_codes, K)
        tb = time.perf_counter() - t0
        exact = bool((np.sort(bd, axis=1) == want).all())
        log(f"[serve] binary {mode}: sorted Hamming distances equal the "
            f"oracle's: {exact}; first search {tb * 1e3:.1f} ms")
        check(exact, f"binary {mode} distances differ from the oracle")
        check(bool(((bi >= 0) & (bi < n)).all()), "binary ids out of range")
        del bidx
    del engine, corpus_host, c_codes
    return enc, variables


# ---------------------------------------------------------------------------
# encoder parity
# ---------------------------------------------------------------------------
def phase_parity(cfg, tok, gen, enc, variables):
    import jax

    from sessionsimilaritysearch.data import build_graph_batch
    from sessionsimilaritysearch.training.loop import to_device

    batch = to_device(build_graph_batch(gen.dataset(64), tok, cfg.dims))
    cpu = jax.devices("cpu")[0]
    apply = jax.jit(enc.apply)
    with jax.default_matmul_precision("float32"):
        out_gpu = np.asarray(apply(variables, batch), np.float64)
        out_cpu = np.asarray(
            apply(jax.device_put(variables, cpu),
                  jax.device_put(batch, cpu)), np.float64)
    check(out_gpu.shape == (64, EMB_DIM), "encoder output shape")
    check(bool(np.isfinite(out_gpu).all()), "non-finite embeddings")
    cos = (out_gpu * out_cpu).sum(1) / (
        np.linalg.norm(out_gpu, axis=1) * np.linalg.norm(out_cpu, axis=1))
    rel = np.abs(out_gpu - out_cpu).max() / np.abs(out_cpu).max()
    log(f"[parity] encoder GPU vs CPU, 64 sessions, matmul precision "
        f"float32: min per-row cosine {cos.min():.8f} (need >= "
        f"{PARITY_COS}), max |diff| / max |out| {rel:.3e}")
    check(float(cos.min()) >= PARITY_COS, "encoder GPU/CPU parity")


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def phase_train(cfg, tok, gen, seed: int):
    import jax

    from sessionsimilaritysearch.data import build_graph_batch
    from sessionsimilaritysearch.training.loop import to_device
    from sessionsimilaritysearch.training.pretrain import (
        create_pretrain_state,
        make_train_step,
    )

    batches = [to_device(build_graph_batch(gen.dataset(256), tok, cfg.dims))
               for _ in range(TRAIN_STEPS)]
    sample = jax.tree.map(lambda a: a[:8], batches[0])
    rng = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    model, state = create_pretrain_state(cfg, rng, sample)
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(state.params))
    log(f"[train] PretrainModel: {n_params} params (asin_num "
        f"{cfg.asin_num}), init {time.perf_counter() - t0:.1f}s")
    step = make_train_step(model, has_view=False)

    # first-step loss: GPU against CPU on one 16-row batch
    small = jax.tree.map(lambda a: a[:16], batches[0])
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("float32"):
        _, m_gpu = step(state, small, rng)
        _, m_cpu = step(jax.device_put(state, cpu),
                        jax.device_put(small, cpu), jax.device_put(rng, cpu))
    l_gpu, l_cpu = float(m_gpu["loss"]), float(m_cpu["loss"])
    log(f"[train] 16-row first step, matmul precision float32: loss GPU "
        f"{l_gpu:.6f} CPU {l_cpu:.6f} (rtol {LOSS_RTOL})")
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= LOSS_RTOL * abs(l_cpu),
          "first-step loss differs between GPU and CPU")

    for i, b in enumerate(batches):
        rng, sub = jax.random.split(rng)
        t0 = time.perf_counter()
        state, m = step(state, b, sub)
        loss = float(m["loss"])
        log(f"[train] step {i}: batch 256, loss {loss:.6f}, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms"
            + (" (compile included)" if i == 0 else ""))
        check(np.isfinite(loss), f"non-finite loss at step {i}")
    check(int(state.step) == len(batches), "step counter")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------
def phase_four_cards(cfg, tok, gen, seed: int):
    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch.data import build_graph_batch
    from sessionsimilaritysearch.engine import SessionSearchEngine
    from sessionsimilaritysearch.index.sharded import global_id_positions
    from sessionsimilaritysearch.ops.topk import l2_normalize
    from sessionsimilaritysearch.parallel import (
        create_mesh,
        shard_batch,
        shard_params,
    )
    from sessionsimilaritysearch.training.loop import to_device
    from sessionsimilaritysearch.training.pretrain import (
        create_pretrain_state,
        make_train_step,
    )

    mesh = create_mesh(devices=jax.devices()[:4])
    ndev = mesh.shape["data"]
    n = 4 * CORPUS_ROWS
    enc, variables, apply = make_encoder(cfg, tok, gen, seed)
    engine = SessionSearchEngine(
        cfg, tok, lambda g: apply(variables, g), dim=EMB_DIM, capacity=n,
        mesh=mesh, metric="cos", batch_size=256, dtype=jnp.bfloat16,
    )
    t0 = time.perf_counter()
    engine.add_sessions(gen.dataset(INGEST_ROWS // 4))
    key = jax.random.PRNGKey(seed + 1)
    fill = 1 << 16
    while engine.index.ntotal < n:
        key, sub = jax.random.split(key)
        m = min(fill, n - engine.index.ntotal)
        engine.index.add(unit_rows(sub, m, EMB_DIM))
    buf = engine.index._buf
    jax.block_until_ready(buf)
    log(f"[4cards] corpus {buf.shape} {buf.dtype} over {ndev} cards: "
        f"{time.perf_counter() - t0:.1f}s")
    shards = buf.addressable_shards
    rows = sorted((s.device.id, s.data.shape) for s in shards)
    log(f"[4cards] shards: {rows}")
    check(len({s.device for s in shards}) == ndev, "one shard per card")
    check(all(s.data.shape == (n // ndev, EMB_DIM) for s in shards),
          "each card holds a quarter of the corpus")

    req = gen.dataset(REQ)
    for r in range(2):
        t0 = time.perf_counter()
        D, I = engine.search(req, k=K)
        log(f"[4cards] request {r}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    q_emb = engine.embed(req, out="device")
    q = l2_normalize(jnp.asarray(q_emb, jnp.bfloat16)).astype(jnp.bfloat16)
    q64 = np.asarray(q[:ORACLE_Q], np.float64)
    host = np.asarray(buf)  # shard-major rows
    o_vals, _ = oracle_topk_chunked(q64, host, K)
    idx = engine.index
    pos = global_id_positions(idx._host_ids, idx._fill,
                              np.asarray(I[:ORACLE_Q]).ravel())
    rec = value_recall(q64, host, pos.reshape(ORACLE_Q, K), o_vals, BF16_TOL)
    log(f"[4cards] sharded search: value-recall@{K} = {rec} "
        f"(rel_tol {BF16_TOL})")
    check(rec == 1.0, f"sharded value-recall@{K} {rec} < 1.0")
    del engine, host, buf

    # one data-parallel pretrain step, asin tables row-sharded
    batch = to_device(build_graph_batch(gen.dataset(256), tok, cfg.dims))
    rng = jax.random.PRNGKey(seed)
    model, state = create_pretrain_state(
        cfg, rng, jax.tree.map(lambda a: a[:8], batch))
    step = make_train_step(model, has_view=False)
    with jax.default_matmul_precision("float32"):
        _, m1 = step(state, batch, rng)
        sharded = state.replace(params=shard_params(state.params, mesh))
        table = sharded.params["target_asin_embedding"]["embedding"]
        log(f"[4cards] asin table {table.shape} sharding {table.sharding.spec}")
        check(all(s.data.shape[0] == table.shape[0] // ndev
                  for s in table.addressable_shards),
              "asin table row-sharded over the cards")
        _, m4 = step(sharded, shard_batch(batch, mesh), rng)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    log(f"[4cards] pretrain step, batch 256: loss 1 card {l1:.6f}, "
        f"{ndev} cards {l4:.6f} (rtol {LOSS_RTOL})")
    check(np.isfinite(l4) and abs(l1 - l4) <= LOSS_RTOL * abs(l1),
          "data-parallel loss differs from the one-device loss")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded serve + data-parallel step "
                         "over four GPUs")
    args = ap.parse_args(argv)

    import jax

    from sessionsimilaritysearch.config import Config
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch.runtime import enable_compile_cache
    from sessionsimilaritysearch.tokenizer import get_tokenizer

    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    log(f"[device] compile cache: {enable_compile_cache()}")
    cfg = Config()
    tok = get_tokenizer(cfg.vocab_size)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=args.seed)
    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards(cfg, tok, gen, args.seed)
    else:
        enc, variables = phase_serve(cfg, tok, gen, args.seed)
        phase_parity(cfg, tok, gen, enc, variables)
        del variables
        phase_train(cfg, tok, gen, args.seed)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
