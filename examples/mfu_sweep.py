"""Training-step MFU: batch sweep + per-stage split + the cached-text
lever. Every escape route from a low training MFU is timed:

1. **Batch sweep** (256 / 512 / 1024 / ...): amortized step time from an
   AOT-compiled step with state-chained data dependencies (no per-step
   host sync inside the window), FLOPs from the executable's own XLA cost
   analysis, MFU vs the card's published bf16 peak
   (``runtime.peak_bf16_flops``, keyed by device kind).
2. **Per-stage split** at each batch: text-encoder forward alone, full
   loss forward, forward+backward (grad), full step (grad + Adam); the
   asin-table share comes from an ablated step compiled at asin_num=8192
   over id-remapped copies of the same graphs.
3. **The structural lever, measured**: the text backbone is FROZEN
   (TextEncoder.freeze stop_gradient = the reference's .detach(),
   model/NodeEmbedding.py:115) and weight-decay-free, so its per-step
   forward recomputes a constant function of the token rows. The
   cached-table step (training.pretrain tables=) replaces it with
   catalog gathers — same loss bit-for-bit (tests/test_pretrain.py) —
   and this script times it at every batch size.

Reference anchor: pretrain_filtered_amazon.py:353-610 (the training loop
whose throughput this bounds).

Run (GPU):  python examples/mfu_sweep.py --out runs/mfu_sweep.json
Smoke:      python examples/mfu_sweep.py --platform cpu --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

def _flops_of(compiled):
    try:
        cost = compiled.cost_analysis()
    except Exception:
        return None
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    v = (cost or {}).get("flops")
    return float(v) if v else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="256,512,1024")
    ap.add_argument("--cached-only", action="store_true", help=(
        "measure only the cached-text step (the production campaign "
        "mode). The uncached step also runs the frozen text backbone's "
        "forward (B x ~42 seqs x 12 layers at 768-d) every step."))
    ap.add_argument("--steps", type=int, default=24,
                    help="timed steps per point")
    ap.add_argument("--sessions", type=int, default=40_960)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--ablate-asin-num", type=int, default=8_192)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
        peak_bf16_flops,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()
    peak = peak_bf16_flops(jax.devices()[0])

    from sessionsimilaritysearch.config import Config, tiny_test_config
    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch.evalharness.harness import (
        build_keyword_table,
        build_title_table,
        keyword_ids,
    )
    from sessionsimilaritysearch.models.encoder import (
        build_pretrain_encoder,
    )
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import to_device
    from sessionsimilaritysearch.training.pretrain import (
        create_pretrain_state,
        make_train_step,
    )

    if args.tiny:
        cfg = tiny_test_config()
        args.batches = "8,16"
        args.steps = 3
        args.sessions = 128
        args.ablate_asin_num = 256
    else:
        cfg = Config().replace(asin_num=args.asin_num)
    batch_sizes = [int(b) for b in args.batches.split(",")]

    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=3)
    t0 = time.perf_counter()
    data = gen.dataset(args.sessions)
    print(f"# {len(data)} sessions in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    tok = get_tokenizer(cfg.vocab_size)

    def batches_for(B, n, cfg_, remap_asins=None):
        """n device-resident batches of size B (pre-uploaded: the sweep
        times the DEVICE step, not host uploads)."""
        loader = SessionGraphLoader(
            data, tok, cfg_.dims, B, shuffle=True, seed=1,
            ignore_query=cfg_.ignore_query, drop_last=True, cache=False,
        )
        out = []
        for b in loader:
            if remap_asins is not None:
                b = b._replace(
                    product_asin=b.product_asin % remap_asins,
                    product_target_y=b.product_target_y % remap_asins,
                )
            out.append(to_device(b))
            if len(out) >= n:
                break
        loader.close()
        return out

    def timed(run, chain, n, warm=2):
        """Amortized wall per call: `run(x)` returns the next carrier via
        `chain`; one materialization closes the window."""
        x = None
        for _ in range(warm):
            x = chain(run(x))
        np.asarray(jax.tree.leaves(x)[0])
        t0 = time.perf_counter()
        for _ in range(n):
            x = chain(run(x))
        np.asarray(jax.tree.leaves(x)[0])
        return (time.perf_counter() - t0) / n

    rng = jax.random.PRNGKey(0)
    results = {"config": {"asin_num": cfg.asin_num,
                          "dims": f"gnn {cfg.gnn_nhid}/{cfg.gnn_nout} "
                                  f"text {cfg.text_encoder_dim}",
                          "steps_per_point": args.steps},
               "device": {"platform": jax.devices()[0].platform,
                          "kind": jax.devices()[0].device_kind,
                          "count": len(jax.devices())},
               "points": []}
    if args.out and os.path.exists(args.out):
        # Resume: keep measured points, only run the missing batch sizes.
        prev = json.load(open(args.out))
        results["points"] = prev.get("points", [])
        done = {p["batch_size"] for p in results["points"]}
        batch_sizes = [b for b in batch_sizes if b not in done]
        print(f"# resume: have {sorted(done)}, running {batch_sizes}",
              file=sys.stderr)

    if args.cached_only:
        # Params/tables are batch-size-independent: init ONCE from a
        # small sample and reuse across the sweep (the per-point
        # state+table build is what OOM'd the B=512 point next to its
        # 8 preloaded batches).
        cfg0 = cfg.replace(batch_size=8)
        bats0 = batches_for(8, 1, cfg0)
        model, state = create_pretrain_state(cfg0, rng, bats0[0])
        raw_step = make_train_step(model, has_view=False)
        enc_vars = {"params": state.params["encoder"]}
        enc_mod = build_pretrain_encoder(cfg0)
        t0 = time.perf_counter()
        title_table = build_title_table(
            cfg0, tok, gen.titles, enc_mod, enc_vars, batch_size=2048)
        kws = sorted({a[2] or "" for d in data[:4096]
                      for a in d[0] + d[1] if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(
            cfg0, tok, kws, enc_mod, enc_vars, batch_size=2048)
        table_build_s = round(time.perf_counter() - t0, 1)
        del bats0, enc_vars, enc_mod

        for B in batch_sizes:
            cfg_b = cfg.replace(batch_size=B)
            bats = batches_for(B, max(2, min(4, args.sessions // B)),
                               cfg_b)
            sample = bats[0]
            point = {"batch_size": B,
                     "uncached": "skipped (--cached-only)",
                     "table_build_s": table_build_s}
            kw_grids = [keyword_ids(kw_lookup,
                                    np.asarray(b.query_input_ids))
                        for b in bats]
            assert all(k is not None for k in kw_grids)
            kw_grids = [jax.device_put(jnp.asarray(k)) for b, k in
                        zip(bats, kw_grids)]
            tables0 = {"title_table": title_table, "query_table": qtable,
                       "query_kw": kw_grids[0]}
            t0 = time.perf_counter()
            c_cached = jax.jit(
                lambda s, g, r, tb: raw_step(s, g, r, None, tb)
            ).lower(state, sample, rng, tables0).compile()
            point["cached_compile_s"] = round(time.perf_counter() - t0, 1)
            cf = _flops_of(c_cached)
            point["cached_flops_per_step_g"] = (
                round(cf / 1e9, 1) if cf else None)
            holder = {"state": state}

            def run_cached(_x, _c=c_cached, _h=holder, _b=bats,
                           _k=kw_grids):
                i = np.random.randint(len(_b))
                tb = {"title_table": title_table, "query_table": qtable,
                      "query_kw": _k[i]}
                s, m = _c(_h["state"], _b[i], rng, tb)
                _h["state"] = s
                return m["loss"]

            dt_c = timed(run_cached, lambda x: x, args.steps)
            # the holder's stepped state is discarded per point; `state`
            # (the pristine init) seeds the next batch size.
            point["cached_step_ms"] = round(dt_c * 1e3, 2)
            point["cached_sessions_per_s_device"] = round(B / dt_c, 1)
            if cf:
                point["cached_achieved_tflops"] = round(
                    cf / dt_c / 1e12, 2)
            if cf and peak:
                point["cached_mfu_vs_bf16_peak"] = round(
                    cf / dt_c / peak, 4)
            results["points"].append(point)
            print(json.dumps(point), flush=True)
            del bats, sample, kw_grids, tables0, c_cached, run_cached
            del holder
            import gc
            gc.collect()
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
            print(f"wrote {args.out}", file=sys.stderr)
        return

    for B in batch_sizes:
        cfg_b = cfg.replace(batch_size=B)
        bats = batches_for(B, max(4, min(8, args.sessions // B)), cfg_b)
        sample = bats[0]
        model, state = create_pretrain_state(cfg_b, rng, sample)
        raw_step = make_train_step(model, has_view=False)

        point = {"batch_size": B}
        holder = {"state": state}
        enc_vars = {"params": state.params["encoder"]}
        enc_mod = build_pretrain_encoder(cfg_b)
        dt = None

        # --- full step (uncached)
        t0 = time.perf_counter()
        compiled = jax.jit(
            lambda s, g, r: raw_step(s, g, r)
        ).lower(state, sample, rng).compile()
        point["compile_s"] = round(time.perf_counter() - t0, 1)
        flops = _flops_of(compiled)
        point["flops_per_step_g"] = round(flops / 1e9, 1) if flops else None

        holder = {"state": state}

        def run_step(_x, _c=compiled, _h=holder, _b=bats):
            i = np.random.randint(len(_b))
            s, m = _c(_h["state"], _b[i], rng)
            _h["state"] = s
            return m["loss"]

        dt = timed(run_step, lambda x: x, args.steps)
        point["step_ms"] = round(dt * 1e3, 2)
        point["sessions_per_s_device"] = round(B / dt, 1)
        if flops:
            point["achieved_tflops"] = round(flops / dt / 1e12, 2)
        if flops and peak:
            point["mfu_vs_bf16_peak"] = round(flops / dt / peak, 4)

        # --- stage split: text fwd | loss fwd | grad | (step above)
        enc_vars = {"params": holder["state"].params["encoder"]}
        enc_mod = build_pretrain_encoder(cfg_b)

        ids = jnp.concatenate(
            [sample.query_input_ids, sample.product_input_ids], axis=1)
        typ = jnp.concatenate(
            [sample.query_type_ids, sample.product_type_ids], axis=1)
        att = jnp.concatenate(
            [sample.query_attention_mask, sample.product_attention_mask],
            axis=1)
        Bn, N, T = ids.shape
        text_fwd = jax.jit(lambda i_, t_, a_, p: enc_mod.apply(
            p, i_.reshape(Bn * N, T), t_.reshape(Bn * N, T),
            a_.reshape(Bn * N, T), method="embed_texts"))
        c_text = text_fwd.lower(ids, typ, att, enc_vars).compile()
        dt_text = timed(
            lambda x, _c=c_text: _c(ids, typ, att, enc_vars),
            lambda x: x, args.steps)
        point["text_fwd_ms"] = round(dt_text * 1e3, 2)
        tf = _flops_of(c_text)
        point["text_fwd_flops_g"] = round(tf / 1e9, 1) if tf else None

        st0 = holder["state"]

        def loss_only(s, g, r):
            variables = {"params": s.params}
            if s.batch_stats is not None:
                variables["batch_stats"] = s.batch_stats
            (l, m), _ = s.apply_fn(variables, g, r, None,
                                   deterministic=False,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": r})
            return l

        c_fwd = jax.jit(loss_only).lower(st0, sample, rng).compile()
        dt_fwd = timed(lambda x, _c=c_fwd: _c(st0, sample, rng),
                       lambda x: x, args.steps)
        point["loss_fwd_ms"] = round(dt_fwd * 1e3, 2)

        c_grad = jax.jit(
            lambda s, g, r: jax.grad(
                lambda p: loss_only(s.replace(params=p), g, r)
            )(s.params)
        ).lower(st0, sample, rng).compile()
        dt_grad = timed(lambda x, _c=c_grad: _c(st0, sample, rng),
                        lambda x: jax.tree.leaves(x)[0], args.steps)
        point["fwd_bwd_ms"] = round(dt_grad * 1e3, 2)
        point["optimizer_ms_derived"] = round((dt - dt_grad) * 1e3, 2)

        # --- asin-table share: same graphs, table ablated to 8k rows
        cfg_a = cfg_b.replace(asin_num=args.ablate_asin_num)
        bats_a = batches_for(B, 2, cfg_a, remap_asins=args.ablate_asin_num)
        model_a, state_a = create_pretrain_state(cfg_a, rng, bats_a[0])
        c_abl = jax.jit(
            lambda s, g, r: make_train_step(model_a, has_view=False)(
                s, g, r)
        ).lower(state_a, bats_a[0], rng).compile()
        holder_a = {"state": state_a}

        def run_abl(_x, _c=c_abl, _h=holder_a, _b=bats_a):
            s, m = _c(_h["state"], _b[0], rng)
            _h["state"] = s
            return m["loss"]

        dt_abl = timed(run_abl, lambda x: x, args.steps)
        point["step_ms_asin8k"] = round(dt_abl * 1e3, 2)
        point["asin_table_ms_derived"] = round((dt - dt_abl) * 1e3, 2)

        # --- the lever: cached-text step (tables as traced args)
        t0 = time.perf_counter()
        title_table = build_title_table(
            cfg_b, tok, gen.titles, enc_mod, enc_vars, batch_size=2048)
        kws = sorted({a[2] or "" for d in data[:4096] for a in d[0] + d[1]
                      if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(
            cfg_b, tok, kws, enc_mod, enc_vars, batch_size=2048)
        point["table_build_s"] = round(time.perf_counter() - t0, 1)
        kw_grids = [keyword_ids(kw_lookup, np.asarray(b.query_input_ids))
                    for b in bats]
        assert all(k is not None for k in kw_grids), "kw table incomplete"
        kw_grids = [jax.device_put(jnp.asarray(k)) for k in kw_grids]
        tables0 = {"title_table": title_table, "query_table": qtable,
                   "query_kw": kw_grids[0]}
        c_cached = jax.jit(
            lambda s, g, r, tb: raw_step(s, g, r, None, tb)
        ).lower(holder["state"], sample, rng, tables0).compile()
        cf = _flops_of(c_cached)
        point["cached_flops_per_step_g"] = round(cf / 1e9, 1) if cf else None
        holder_c = {"state": holder["state"]}

        def run_cached(_x, _c=c_cached, _h=holder_c):
            i = np.random.randint(len(bats))
            tb = {"title_table": title_table, "query_table": qtable,
                  "query_kw": kw_grids[i]}
            s, m = _c(_h["state"], bats[i], rng, tb)
            _h["state"] = s
            return m["loss"]

        dt_c = timed(run_cached, lambda x: x, args.steps)
        point["cached_step_ms"] = round(dt_c * 1e3, 2)
        point["cached_sessions_per_s_device"] = round(B / dt_c, 1)
        point["cached_speedup"] = round(dt / dt_c, 2)
        if cf:
            point["cached_achieved_tflops"] = round(cf / dt_c / 1e12, 2)
        if cf and peak:
            point["cached_mfu_vs_bf16_peak"] = round(cf / dt_c / peak, 4)
        # loss parity on this very batch (the tiny-config test pins it;
        # this is the flagship-dims spot check)
        l_u = float(c_fwd(st0, sample, rng))
        l_c = float(c_cached(st0, sample, rng, tables0)[1]["loss"])
        point["cached_loss_rel_dev"] = round(
            abs(l_u - l_c) / max(abs(l_u), 1e-9), 8)

        results["points"].append(point)
        print(json.dumps(point), flush=True)
        # Free EVERYTHING device-side before the next (bigger) point: the
        # first sweep OOM'd at B=512 because enc_vars (encoder params),
        # tables0 (title/query tables), the B-sized token grids, and the
        # run_* closures (whose cells pin batches/states) all survived the
        # original del list.
        del compiled, c_text, c_fwd, c_grad, c_abl, c_cached
        del bats, bats_a, title_table, qtable, kw_grids, holder, holder_c
        del state, state_a, st0, enc_vars, enc_mod, tables0, sample
        del ids, typ, att, model, model_a, holder_a
        del run_step, run_abl, run_cached, text_fwd, loss_only
        import gc
        gc.collect()
        if args.out:  # checkpoint after every point (OOM-resumable)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
