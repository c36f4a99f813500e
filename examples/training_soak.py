"""Epoch-scale training soak at flagship dims.

The reference trains 60 epochs over 3M sessions
(pretrain_filtered_amazon.py:215, config.py:22); prior rounds here proved
the step but never sustained it. This soak runs the FULL 10-head pretrain
loss menu -- next/all-product sampled-negative BCE, next/all-query and
next/all-title text-embedding heads, QAEA distillation, query/product node
reconstruction, token ELECTRA, and the contrastive-view objective -- ON
TOGETHER at the reference's model scale (768/800 -> 1600-d,
asin_num=391,572), over >= 1 epoch of a large synthetic corpus, through the
production ``run_training`` loop with mid-run checkpoint+resume and a
FORCED NaN-rollback drill.

The reference keeps all auxiliary head weights commented out at 0
(pretrain_filtered_amazon.py:473-490 leaves only next_product active), so
there are no published weights to copy; the soak's point is sustained
all-heads mechanics, run with uniform small weights (0.1, ctv 0.5).

Outputs: loss curve + step-time percentiles + drill/resume evidence as one
JSON (``--out``).

Run (GPU): python examples/training_soak.py --sessions 500000
Smoke:     python examples/training_soak.py --platform cpu --tiny
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sessionsimilaritysearch.config import Config, tiny_test_config
from sessionsimilaritysearch.data import SyntheticSessionGenerator
from sessionsimilaritysearch.data.augment import random_exchange_order
from sessionsimilaritysearch.data.loader import (
    ContrastiveViewLoader,
    SessionGraphLoader,
)
from sessionsimilaritysearch.tokenizer import get_tokenizer
from sessionsimilaritysearch.training.loop import run_training, to_device
from sessionsimilaritysearch.training.pretrain import (
    PretrainModel,
    make_train_step,
)
from sessionsimilaritysearch.training.train_state import (
    adam_with_clip,
    create_train_state,
)
from sessionsimilaritysearch.utils.checkpoint import CheckpointManager
from sessionsimilaritysearch.utils.logging import RunDir


class _PairLoader:
    """Adapts ContrastiveViewLoader's (batch, view) pairs to run_training's
    single-batch iteration (the pair rides as one pytree)."""

    def __init__(self, inner):
        self.inner = inner

    def __iter__(self):
        for b, v in self.inner:
            yield (b, v)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=500_000)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--nan-step", type=int, default=None,
                    help="inject a poisoned batch at this step "
                         "(default: mid-epoch)")
    ap.add_argument("--resume-at", type=int, default=None,
                    help="simulate a crash: stop after this many steps, "
                         "then restart from the checkpoint "
                         "(default: ~2/3 of the first epoch)")
    ap.add_argument("--savedir", default="/tmp/soak_run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    from sessionsimilaritysearch.runtime import (
        enable_compile_cache,
        force_platform,
    )

    if args.platform:
        force_platform(args.platform)
    enable_compile_cache()

    weights = dict(ph_w=0.1, qh_w=0.1, pt_w=0.1, qaea_w=0.1, node_w=0.1,
                   token_w=0.1, ctv_w=0.5)
    if args.tiny:
        cfg = tiny_test_config(**weights)
        args.sessions, args.batch_size = 256, 16
        args.asin_num = cfg.asin_num
    else:
        cfg = Config().replace(
            asin_num=args.asin_num, batch_size=args.batch_size, **weights
        )
    steps_per_epoch = args.sessions // args.batch_size
    nan_step = args.nan_step or max(2, steps_per_epoch // 2)
    resume_at = args.resume_at or max(3, (2 * steps_per_epoch) // 3)
    print(f"soak: {args.sessions} sessions x {args.epochs} epochs "
          f"({steps_per_epoch} steps/epoch, batch {args.batch_size}), "
          f"session_emb_dim={cfg.session_emb_dim}, "
          f"asin_num={cfg.asin_num}; NaN drill at step {nan_step}, "
          f"simulated crash after step {resume_at}", flush=True)

    tok = get_tokenizer(cfg.vocab_size)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0)
    t0 = time.perf_counter()
    data = gen.dataset(args.sessions)
    print(f"generate: {time.perf_counter()-t0:.1f}s", flush=True)

    def fresh_loader():
        base = SessionGraphLoader(data, tok, cfg.dims, args.batch_size,
                                  seed=0, prefetch=4)
        return _PairLoader(ContrastiveViewLoader(
            base, random_exchange_order, seed=1
        ))

    rng = jax.random.PRNGKey(0)
    b0, v0 = next(iter(fresh_loader().inner))
    sample = to_device(b0)
    vsample = to_device(v0)
    model = PretrainModel(cfg)
    state = create_train_state(
        model, rng, (sample, rng), adam_with_clip(cfg.lr),
        init_kwargs={"view_graph": vsample, "deterministic": True},
    )
    n_params = sum(x.size for x in jax.tree.leaves(state.params))
    print(f"params: {n_params/1e6:.1f}M", flush=True)
    raw_step = make_train_step(model, has_view=True)

    # --- instrumented step: per-step wall time, loss log, NaN injection
    times, losses, events = [], [], []
    counter = {"step": 0}

    def step_fn(state, batch, rng):
        b, v = batch
        counter["step"] += 1
        if counter["step"] == nan_step:
            # forced failure drill: poison the query->product adjacency
            # (verified to propagate: the GAT softmax carries it into the
            # session embedding, so every head's loss goes non-finite THIS
            # step -- adj_pp does NOT propagate, its gating masks NaN out);
            # run_training must roll back and continue from healthy params
            b = b._replace(
                adj_qp=jnp.asarray(b.adj_qp, jnp.float32)
                * jnp.float32(np.nan)
            )
            events.append({"step": counter["step"], "event": "nan_injected"})
        t0 = time.perf_counter()
        new_state, m = raw_step(state, b, rng, v)
        jax.block_until_ready(m["loss"])
        dt = time.perf_counter() - t0
        loss = float(m["loss"])
        if np.isfinite(loss):
            times.append(dt)
            losses.append(loss)
        else:
            events.append({"step": counter["step"], "event": "nan_caught"})
        return new_state, m

    ckpt = CheckpointManager(os.path.join(args.savedir, "ckpt"))
    rundir = RunDir(os.path.join(args.savedir, "logs"), cfg)

    # --- phase 1: run until the simulated crash point (checkpoint each
    # "epoch"; we slice the loader so a checkpoint exists before the crash)
    class _Limited:
        def __init__(self, mk, limit):
            self.mk, self.limit = mk, limit

        def __iter__(self):
            n = 0
            for item in self.mk():
                if n >= self.limit:
                    return
                yield item
                n += 1

    t0 = time.perf_counter()
    half = resume_at // 2
    state, _ = run_training(
        state=state, step_fn=step_fn,
        train_loader=_Limited(fresh_loader, half),
        epochs=1, rng=rng, ckpt=ckpt, rundir=rundir, resume=False,
    )
    # phase 1b: NO checkpointing -- this is the work a real crash loses
    # (the NaN drill lands in here; with no ckpt the loop drops the
    # poisoned update and continues)
    state, _ = run_training(
        state=state, step_fn=step_fn,
        train_loader=_Limited(fresh_loader, resume_at - half),
        epochs=1, rng=rng, ckpt=None, rundir=rundir, resume=False,
    )
    crash_step = int(state.step)
    events.append({"step": crash_step, "event": "simulated_crash"})
    print(f"simulated crash at trained step {crash_step} "
          f"({time.perf_counter()-t0:.0f}s so far)", flush=True)

    # --- phase 2: a FRESH state object resumes from the checkpoint and
    # finishes the epoch(s) -- exactly what a restarted job does
    state2 = create_train_state(
        model, jax.random.PRNGKey(0), (sample, jax.random.PRNGKey(0)),
        adam_with_clip(cfg.lr),
        init_kwargs={"view_graph": vsample, "deterministic": True},
    )
    state2, _ = run_training(
        state=state2, step_fn=step_fn,
        train_loader=_Limited(
            fresh_loader,
            steps_per_epoch * args.epochs - resume_at + half,
        ),
        epochs=1, rng=rng, ckpt=ckpt, rundir=rundir, resume=True,
    )
    resumed_from = half  # the only checkpoint is phase 1a's epoch end
    total = time.perf_counter() - t0
    ts = np.asarray(times)
    # compile steps (first call of each trace) dwarf steady-state steps;
    # report steady-state percentiles + the count
    # excluded
    steady = ts[ts < 5 * np.median(ts)] if len(ts) else ts
    n_compile = len(ts) - len(steady)
    result = {
        "sessions": args.sessions,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "asin_num": cfg.asin_num,
        "session_emb_dim": cfg.session_emb_dim,
        "params_m": round(n_params / 1e6, 1),
        "loss_weights": weights,
        "steps_total": int(state2.step),
        "wall_s": round(total, 1),
        "sessions_per_s": round(
            args.batch_size * len(steady) / steady.sum(), 0),
        "step_ms_p50": round(float(np.percentile(steady, 50)) * 1e3, 1),
        "step_ms_p90": round(float(np.percentile(steady, 90)) * 1e3, 1),
        "step_ms_p99": round(float(np.percentile(steady, 99)) * 1e3, 1),
        "compile_steps_excluded": int(n_compile),
        "loss_first20": round(float(np.mean(losses[:20])), 4),
        "loss_last20": round(float(np.mean(losses[-20:])), 4),
        "events": events,
        "loss_curve_every50": [round(float(x), 4) for x in losses[::50]],
    }
    print(json.dumps(result), flush=True)
    ok_drill = any(e["event"] == "nan_caught" for e in events)
    ok_resume = int(state2.step) > resumed_from
    print(f"NaN drill caught+rolled back: {ok_drill}; "
          f"resumed from step {resumed_from} -> {int(state2.step)}: "
          f"{ok_resume}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not (ok_drill and ok_resume):
        sys.exit(1)


if __name__ == "__main__":
    main()
