"""Flagship-scale training run.

Runs pretrain and subsession training at the reference's REAL dimensions --
gnn 800 / text 768 (=> 1600-d session embedding) with the full
asin_num=391,572 embedding table and ~1000 sampled negatives per step
(reference scale anchors: pretrain_filtered_amazon.py:200,215; sampled-BCE
train_subsession_embedding.py counterpart losses.product_asin_loss) -- on
whatever jax.devices()[0] is, measuring compile time, steady-state step
time and the loss curve, then proving checkpoint+resume by re-entering the
loop and continuing from the saved step.

Usage:
  python examples/flagship_train.py --phase pretrain   --steps 200
  python examples/flagship_train.py --phase subsession --steps 200
Options: --batch-size 50 --asin-num 391572 --savedir /tmp/flagship
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["pretrain", "subsession"],
                    default="pretrain")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume-steps", type=int, default=20,
                    help="steps for the follow-up resume-proof run")
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--asin-num", type=int, default=391_572)
    ap.add_argument("--savedir", default="/tmp/flagship_run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from sessionsimilaritysearch.runtime import enable_compile_cache

    enable_compile_cache()
    from sessionsimilaritysearch.config import Config
    from sessionsimilaritysearch.data.loader import SessionGraphLoader
    from sessionsimilaritysearch.data.synthetic import (
        SyntheticSessionGenerator,
    )
    from sessionsimilaritysearch.tokenizer import get_tokenizer
    from sessionsimilaritysearch.training.loop import (
        run_training,
        to_device,
    )
    from sessionsimilaritysearch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch.utils.logging import RunDir

    cfg = Config().replace(
        asin_num=args.asin_num,
        batch_size=args.batch_size,
        savedir=args.savedir,
        seed=args.seed,
    )
    savedir = os.path.join(args.savedir, args.phase)
    os.makedirs(savedir, exist_ok=True)

    n_sessions = args.steps * cfg.batch_size + cfg.batch_size
    print(f"# generating {n_sessions} sessions over a {cfg.asin_num}-asin "
          f"catalog ...", file=sys.stderr)
    t0 = time.perf_counter()
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=cfg.seed)
    data = gen.dataset(n_sessions)
    gen_s = time.perf_counter() - t0
    print(f"# generated in {gen_s:.1f}s", file=sys.stderr)

    tok = get_tokenizer(cfg.vocab_size)
    loader = SessionGraphLoader(
        data, tok, cfg.dims, cfg.batch_size,
        ignore_query=cfg.ignore_query, seed=cfg.seed,
    )
    rng = jax.random.PRNGKey(cfg.seed)
    sample = to_device(next(iter(loader)))

    t0 = time.perf_counter()
    if args.phase == "pretrain":
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state,
            make_train_step,
        )

        model, state = create_pretrain_state(cfg, rng, sample)
        raw_step = make_train_step(model, has_view=False)
    else:
        from sessionsimilaritysearch.training.session_trainers import (
            create_session_state,
            make_session_train_step,
        )

        model, state = create_session_state(
            cfg, rng, sample, mode="subsession"
        )
        raw_step = make_session_train_step(model)
    init_s = time.perf_counter() - t0
    n_params = sum(
        int(np.prod(p.shape)) for p in jax.tree.leaves(state.params)
    )
    print(f"# init {init_s:.1f}s, {n_params/1e6:.1f}M params",
          file=sys.stderr)

    step_times = []
    losses = []

    def timed_step(state, batch, rng):
        t0 = time.perf_counter()
        state, m = raw_step(state, batch, rng)
        losses.append(float(m["loss"]))  # materializes: true device sync
        step_times.append(time.perf_counter() - t0)
        return state, m

    rundir = RunDir(savedir, cfg, args.phase)
    ckpt = CheckpointManager(os.path.join(savedir, "ckpt"))

    t0 = time.perf_counter()
    state, _ = run_training(
        state=state, step_fn=timed_step, train_loader=loader,
        epochs=1, rng=rng, rundir=rundir, ckpt=ckpt, log_every=10,
    )
    train_s = time.perf_counter() - t0
    final_step = int(state.step)

    st = np.asarray(step_times[1:]) if len(step_times) > 1 else np.asarray(
        step_times
    )
    summary = {
        "phase": args.phase,
        "asin_num": cfg.asin_num,
        "batch_size": cfg.batch_size,
        "params_m": round(n_params / 1e6, 1),
        "steps": final_step,
        "compile_step_s": round(step_times[0], 1) if step_times else None,
        "step_ms_median": round(float(np.median(st)) * 1e3, 1),
        "step_ms_p90": round(float(np.percentile(st, 90)) * 1e3, 1),
        "sessions_per_s": round(cfg.batch_size / float(np.median(st)), 1),
        "loss_first10_mean": round(float(np.mean(losses[:10])), 4),
        "loss_last10_mean": round(float(np.mean(losses[-10:])), 4),
        "train_wall_s": round(train_s, 1),
        "platform": jax.devices()[0].platform,
    }

    # --- checkpoint+resume proof: re-enter the loop; run_training restores
    # 'latest' and continues; assert the step counter carried over.
    resume_data = gen.dataset(args.resume_steps * cfg.batch_size)
    resume_loader = SessionGraphLoader(
        resume_data, tok, cfg.dims, cfg.batch_size,
        ignore_query=cfg.ignore_query, seed=cfg.seed + 1,
    )
    if args.phase == "pretrain":
        from sessionsimilaritysearch.training.pretrain import (
            create_pretrain_state as mk,
        )

        _, fresh = mk(cfg, rng, sample)
    else:
        from sessionsimilaritysearch.training.session_trainers import (
            create_session_state as mk,
        )

        _, fresh = mk(cfg, rng, sample, mode="subsession")
    assert int(fresh.step) == 0
    resumed, _ = run_training(
        state=fresh, step_fn=timed_step, train_loader=resume_loader,
        epochs=1, rng=rng, rundir=rundir, ckpt=ckpt,
    )
    assert int(resumed.step) == final_step + args.resume_steps, (
        int(resumed.step), final_step, args.resume_steps,
    )
    summary["resume_check"] = (
        f"restored step {final_step}, continued to {int(resumed.step)}"
    )
    summary["loss_resumed10_mean"] = round(
        float(np.mean(losses[final_step:final_step + 10])), 4
    )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
