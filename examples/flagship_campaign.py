"""Flagship-scale training CAMPAIGN.

Takes training evidence toward the reference's operating scale — the
reference pretrains over ~3M filtered-Amazon sessions x 60 epochs
(pretrain_filtered_amazon.py:212-215, config.py max_epoch) — with a
multi-epoch pretrain over >=1M synthetic sessions at the reference's REAL
dimensions (gnn 800 / text 768 => 1600-d session embedding,
asin_num=391,572), and reports what a production training owner watches:

- steps/s and sessions/s sustained over the whole campaign (not a
  10-step sample),
- **training-step MFU vs the card's published bf16 peak**
  (``runtime.peak_bf16_flops``), from the compiled step's own XLA cost
  analysis — no hand-counted FLOPs,
- the loss curve (sampled every --log-every steps, persisted across
  process restarts),
- a mid-campaign **crash/resume drill**: --crash-at-step N hard-kills the
  process (os._exit) mid-epoch; re-running the same command restores the
  last step-granular checkpoint, fast-forwards the SAME shuffled
  batch order to the exact batch position, and continues — the summary
  records the seam and the steps replayed.

Design notes:
- ONE compile: the step is AOT-lowered and compiled once
  (`jit(...).lower(...).compile()`); the same executable serves the whole
  campaign and exposes `cost_analysis()` for the MFU numerator.
- The loop only materializes the loss every --log-every steps, so JAX's
  async dispatch keeps the device queue full between syncs; a short timed
  window with per-step materialization supplies the step-latency stats.
- Checkpoints every --ckpt-every steps via CheckpointManager,
  with a meta record {epoch, batch_idx, global_step} for exact-position
  resume; per-step RNG is `fold_in(base, global_step)` so the stream is
  identical across restarts.

Run (GPU):
  python examples/flagship_campaign.py --sessions 1000000 --epochs 3 \
      --out runs/flagship_campaign.json
Crash drill (same savedir; run, die, re-run to completion):
  python examples/flagship_campaign.py ... --crash-at-step 6000
  python examples/flagship_campaign.py ...            # resumes + finishes
Smoke: python examples/flagship_campaign.py --platform cpu --tiny
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

def _append_event(path: str, ev: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(ev) + "\n")


def _read_events(path: str) -> list:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _flops_of(compiled) -> float | None:
    """Total FLOPs of one compiled step from XLA's own cost analysis."""
    try:
        cost = compiled.cost_analysis()
    except Exception:
        return None
    if isinstance(cost, (list, tuple)):  # older jax returns [dict]
        cost = cost[0] if cost else {}
    v = (cost or {}).get("flops")
    return float(v) if v else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--ckpt-every", type=int, default=500,
                    help="checkpoint cadence in steps")
    ap.add_argument("--log-every", type=int, default=50,
                    help="loss materialization/sampling cadence in steps")
    ap.add_argument("--timed-window", type=int, default=40,
                    help="steps timed with per-step sync for latency stats")
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="hard-exit (os._exit 3) at this global step")
    ap.add_argument("--cached-text", action="store_true",
                    help="serve the frozen text backbone from precomputed "
                         "title/keyword tables (training.pretrain tables=; "
                         "loss-parity pinned by tests/test_pretrain.py). "
                         "Measured ~2x+ step at flagship dims "
                         "(examples/mfu_sweep.py)")
    ap.add_argument("--savedir", default="/tmp/flagship_campaign")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()

    import jax

    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
        peak_bf16_flops,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()

    from sessionsimilaritysearch.config import Config, tiny_test_config
    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import to_device
    from sessionsimilaritysearch.training.pretrain import (
        create_pretrain_state,
        make_train_step,
    )
    from sessionsimilaritysearch.utils.checkpoint import (
        CheckpointManager,
        state_to_tree,
        tree_to_state,
    )

    if args.tiny:
        cfg = tiny_test_config().replace(batch_size=32, seed=args.seed)
        args.sessions = min(args.sessions, 1024)
        args.epochs = min(args.epochs, 2)
        args.ckpt_every = min(args.ckpt_every, 4)
        args.log_every = min(args.log_every, 2)
        args.timed_window = min(args.timed_window, 5)
    else:
        cfg = Config().replace(
            asin_num=args.asin_num,
            batch_size=args.batch_size,
            seed=args.seed,
        )

    os.makedirs(args.savedir, exist_ok=True)
    log_path = os.path.join(args.savedir, "campaign_log.jsonl")
    ckpt = CheckpointManager(os.path.join(args.savedir, "ckpt"))

    # --- data: generated once per invocation, deterministically — the
    # same --seed always yields the same corpus, so a resumed process
    # trains on identical data (the reference re-reads its CSV the same
    # way, pretrain_filtered_amazon.py:212).
    t0 = time.perf_counter()
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
    data = gen.dataset(args.sessions)
    gen_s = time.perf_counter() - t0
    steps_per_epoch = len(data) // cfg.batch_size  # drop_last
    total_steps = steps_per_epoch * args.epochs
    print(f"# {len(data)} sessions generated in {gen_s:.1f}s; "
          f"{steps_per_epoch} steps/epoch x {args.epochs} epochs "
          f"= {total_steps} steps", file=sys.stderr)

    tok = get_tokenizer(cfg.vocab_size)

    def make_loader(epoch: int) -> SessionGraphLoader:
        # per-epoch seed => a fresh but REPRODUCIBLE shuffle; resume
        # rebuilds the identical permutation and fast-forwards.
        return SessionGraphLoader(
            data, tok, cfg.dims, cfg.batch_size, shuffle=True,
            ignore_query=cfg.ignore_query, drop_last=True, cache=False,
            seed=args.seed * 1009 + epoch, prefetch=2,
        )

    # --- model + ONE AOT compile
    rng = jax.random.PRNGKey(cfg.seed)
    warm_loader = make_loader(0)
    sample = to_device(next(iter(warm_loader)))
    warm_loader.close()
    # Init from a sliced-to-8 sample: params are batch-size-independent
    # and the SAME rng gives the SAME params (restart determinism holds),
    # but tracing init at the full batch allocates multi-GB of transient
    # device memory at flagship dims, enough to push the subsequent
    # cached-text table build over the edge at B=512.
    init_sample = jax.tree.map(lambda a: a[:8], sample)
    model, state = create_pretrain_state(
        cfg.replace(batch_size=8), rng, init_sample)
    del init_sample
    n_params = sum(
        int(np.prod(p.shape)) for p in jax.tree.leaves(state.params)
    )
    raw_step = make_train_step(model, has_view=False)

    # --- cached-text mode: the text backbone is frozen (stop_gradient +
    # wd=0), so its per-step forward is a constant function of the token
    # rows — precompute the title/keyword catalogs once (deterministic
    # across restarts: same seed => same init params) and train on
    # gathers. The token-grid fields the cached step never reads are
    # replaced with device-resident zeros per batch, cutting the per-step
    # host->device upload too.
    make_tables = None
    strip_fields = ()
    if args.cached_text:
        import jax.numpy as jnp

        from sessionsimilaritysearch.evalharness.harness import (
            build_keyword_table,
            build_title_table,
            keyword_ids,
        )
        from sessionsimilaritysearch.models.encoder import (
            build_pretrain_encoder,
        )

        t0 = time.perf_counter()
        enc_mod = build_pretrain_encoder(cfg)
        enc_vars = {"params": state.params["encoder"]}
        title_table = build_title_table(
            cfg, tok, gen.titles, enc_mod, enc_vars, batch_size=2048)
        kws = sorted({a[2] or "" for pair in data for seq in pair
                      for a in seq if a[1] == "s"})
        qtable, kw_lookup = build_keyword_table(
            cfg, tok, kws, enc_mod, enc_vars, batch_size=2048)
        print(f"# cached-text tables: {title_table.shape[0]} titles + "
              f"{qtable.shape[0]} keywords in "
              f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)

        def make_tables(host_batch):
            kw = keyword_ids(kw_lookup, np.asarray(
                host_batch.query_input_ids))
            assert kw is not None, "keyword outside the prebuilt table"
            return {"title_table": title_table, "query_table": qtable,
                    "query_kw": jnp.asarray(kw)}

        strip_fields = (
            "query_input_ids", "query_type_ids", "query_attention_mask",
            "product_input_ids", "product_type_ids",
            "product_attention_mask",
            "text_input_ids", "text_type_ids", "text_attention_mask",
            "product_target_input_ids", "product_target_type_ids",
            "product_target_attention_mask",
            "query_target_input_ids", "query_target_type_ids",
            "query_target_attention_mask",
        )
        dev_zeros = {
            f: jnp.zeros_like(getattr(sample, f)) for f in strip_fields
        }

    t0 = time.perf_counter()
    if args.cached_text:
        tables0 = make_tables(sample)
        compiled_t = jax.jit(
            lambda s, g, r, tb: raw_step(s, g, r, None, tb)
        ).lower(state, sample, rng, tables0).compile()
        compiled = None
    else:
        compiled = raw_step.lower(state, sample, rng).compile()
        compiled_t = None
    compile_s = time.perf_counter() - t0
    flops_per_step = _flops_of(compiled_t if compiled is None else compiled)
    print(f"# {n_params/1e6:.1f}M params, compile {compile_s:.1f}s, "
          f"{(flops_per_step or 0)/1e9:.1f} GFLOP/step", file=sys.stderr)

    # --- resume position
    start_epoch, start_batch, global_step = 0, 0, 0
    resumed_from = None
    if ckpt.has("latest") and ckpt.has("campaign_meta"):
        tree = ckpt.restore("latest", state_to_tree(state))
        state = tree_to_state(state, tree)
        meta = ckpt.restore("campaign_meta")
        start_epoch = int(np.asarray(meta["epoch"]))
        start_batch = int(np.asarray(meta["batch_idx"]))
        global_step = int(np.asarray(meta["global_step"]))
        assert global_step == int(state.step), (global_step, int(state.step))
        resumed_from = {"epoch": start_epoch, "batch_idx": start_batch,
                        "global_step": global_step}
        print(f"# resumed at step {global_step} "
              f"(epoch {start_epoch}, batch {start_batch})", file=sys.stderr)
    _append_event(log_path, {
        "event": "start", "resumed_from": resumed_from,
        "crash_at_step": args.crash_at_step, "t": time.time(),
    })

    base_rng = jax.random.PRNGKey(args.seed + 17)
    step_times: list = []
    pending = None  # (step, metrics) not yet materialized
    train_t0 = time.perf_counter()
    trained_this_run = 0

    def save(epoch: int, batch_idx: int) -> None:
        ckpt.save("latest", state_to_tree(state))
        ckpt.save("campaign_meta", {
            "epoch": np.asarray(epoch),
            "batch_idx": np.asarray(batch_idx),
            "global_step": np.asarray(global_step),
        })

    for epoch in range(start_epoch, args.epochs):
        loader = make_loader(epoch)
        skip = start_batch if epoch == start_epoch else 0
        ff_t0 = time.perf_counter()
        it = iter(loader)
        for _ in range(skip):  # fast-forward the shuffled order
            next(it)
        if skip:
            _append_event(log_path, {
                "event": "fast_forward", "epoch": epoch, "batches": skip,
                "s": round(time.perf_counter() - ff_t0, 1)})
        batch_idx = skip
        for batch in it:
            sub = jax.random.fold_in(base_rng, global_step)
            timed = len(step_times) < args.timed_window and skip == 0
            t0 = time.perf_counter()
            if compiled_t is not None:
                tables = make_tables(batch)  # host token grids, pre-strip
                dev_batch = to_device(batch._replace(
                    **{f: dev_zeros[f] for f in strip_fields}))
                state, m = compiled_t(state, dev_batch, sub, tables)
            else:
                state, m = compiled(state, to_device(batch), sub)
            global_step += 1
            batch_idx += 1
            trained_this_run += 1
            if timed:
                loss = float(m["loss"])  # true device sync
                step_times.append(time.perf_counter() - t0)
                pending = None
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss={loss} @ {global_step}")
            else:
                pending = (global_step, m)
            if global_step % args.log_every == 0 or timed:
                if pending is not None:
                    loss = float(pending[1]["loss"])  # sync point
                    pending = None
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss={loss} @ {global_step}")
                _append_event(log_path, {
                    "event": "loss", "step": global_step, "epoch": epoch,
                    "loss": round(loss, 5)})
            if global_step % args.ckpt_every == 0:
                save(epoch, batch_idx)
            if args.crash_at_step == global_step:
                print(f"# CRASH DRILL: os._exit(3) at step {global_step}",
                      file=sys.stderr)
                sys.stderr.flush()
                os._exit(3)
        loader.close()
        start_batch = 0
        save(epoch + 1, 0)
        _append_event(log_path, {
            "event": "epoch_done", "epoch": epoch, "step": global_step,
            "wall_s": round(time.perf_counter() - train_t0, 1)})

    train_s = time.perf_counter() - train_t0

    # --- summary over the WHOLE campaign (all invocations), from the log
    events = _read_events(log_path)
    raw_losses = [(e["step"], e["loss"])
                  for e in events if e["event"] == "loss"]
    raw_losses.sort()
    # steps between the last checkpoint and a crash are REPLAYED on resume
    # (same restored state, same fold_in rng, same batch order), so a
    # duplicated step's loss must reproduce — a free determinism check on
    # the whole restore path
    by_step: dict = {}
    replay_max_dev = 0.0
    for s_, v in raw_losses:
        if s_ in by_step:
            replay_max_dev = max(replay_max_dev, abs(v - by_step[s_]))
        by_step[s_] = v
    losses = sorted(by_step.items())
    first10 = [v for _, v in losses[:10]]
    last10 = [v for _, v in losses[-10:]]
    st = np.asarray(step_times[1:] if len(step_times) > 1 else step_times)
    step_ms = float(np.median(st)) * 1e3 if st.size else None
    # sustained throughput: this invocation's trained steps over its wall
    # (includes host graph building, logging, checkpoint saves)
    sustained_sps = trained_this_run / train_s if train_s > 0 else None
    mfu = None
    achieved_tflops = None
    if flops_per_step and step_ms:
        achieved_tflops = flops_per_step / (step_ms / 1e3) / 1e12
        peak = peak_bf16_flops(jax.devices()[0])
        mfu = achieved_tflops * 1e12 / peak if peak else None
    crash_events = [e for e in events
                    if e["event"] == "start" and e["resumed_from"]]
    summary = {
        "sessions": len(data), "epochs": args.epochs,
        "batch_size": cfg.batch_size, "asin_num": cfg.asin_num,
        "params_m": round(n_params / 1e6, 1),
        "steps_total": global_step,
        "steps_per_epoch": steps_per_epoch,
        "gen_s": round(gen_s, 1),
        "compile_s": round(compile_s, 1),
        "flops_per_step_g": (round(flops_per_step / 1e9, 1)
                             if flops_per_step else None),
        "step_ms_median_timed_window": (round(step_ms, 1)
                                        if step_ms else None),
        "step_ms_p90_timed_window": (round(float(np.percentile(st, 90))
                                           * 1e3, 1) if st.size else None),
        "achieved_tflops": (round(achieved_tflops, 1)
                            if achieved_tflops else None),
        "device_kind": jax.devices()[0].device_kind,
        "mfu_vs_bf16_peak": round(mfu, 3) if mfu else None,
        # steps/s sustained by THIS invocation's training loop (trained
        # steps over its wall — well-defined even after a crash/resume, so
        # the field is never null)
        "sustained_steps_per_s": (round(trained_this_run / train_s, 2)
                                  if train_s > 0 and trained_this_run
                                  else None),
        "sustained_sessions_per_s_this_run": (
            round(sustained_sps * cfg.batch_size, 1)
            if sustained_sps else None),
        "train_wall_s_this_run": round(train_s, 1),
        "loss_first10_mean": (round(float(np.mean(first10)), 4)
                              if first10 else None),
        "loss_last10_mean": (round(float(np.mean(last10)), 4)
                             if last10 else None),
        "loss_curve": losses[:: max(1, len(losses) // 200)],
        "resume_seams": [e["resumed_from"] for e in crash_events],
        "replay_loss_max_dev": round(replay_max_dev, 6),
        "platform": jax.devices()[0].platform,
    }
    _append_event(log_path, {"event": "done", **summary})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "loss_curve"}))


if __name__ == "__main__":
    main()
