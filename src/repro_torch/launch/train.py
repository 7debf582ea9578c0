"""Training launcher (port of ``repro.launch.train``).

Picks the arch config, wires the consistency policy, the replicated
checkpoint store and the trainer, and runs the loop; prints the history,
then the step times and, on the card, the peak device memory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --pods 2 --policy X_STCC
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --reduced --device cpu --steps 50 --policy X_STCC --pods 2

On the card (the default device) it trains the full config at its
published widths with random weights; the CPU takes only ``--reduced``
configs, as the reference does.  ``--dry-run`` (the reference's TPU mesh
compile) is not ported.
"""

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--policy", default="X_STCC")
    ap.add_argument("--delta", type=int, default=8)
    ap.add_argument("--compress", default="none")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        print("--dry-run compiles the reference's TPU mesh programs "
              "(repro.launch.dryrun); the port has no counterpart yet",
              file=sys.stderr)
        return 2

    import torch

    from repro_torch.checkpoint import CheckpointStore, SessionToken
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import ConsistencyLevel, policy_for
    from repro_torch.data import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    elif dev.type == "cpu":
        print("full config on CPU is impractical; pass --reduced",
              file=sys.stderr)
        return 2

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(10, args.steps // 5 + 1),
                      total_steps=args.steps)
    policy = policy_for(args.policy, delta_steps=args.delta,
                        compress_inter_pod=args.compress)
    store = session = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir, n_replicas=3,
                                level=ConsistencyLevel.X_STCC, device=dev)
        session = SessionToken(client_id=0)
    trainer = Trainer(
        cfg, data, opt, policy,
        TrainerConfig(n_steps=args.steps, n_pods=args.pods, log_every=1,
                      ckpt_every=args.ckpt_every),
        ckpt_store=store, ckpt_session=session, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    for h in trainer.history:
        print(h)
    steps = [h for h in trainer.history if h["step"] > 0]  # the first warms up
    tokens = args.batch * args.seq
    for synced in (False, True):
        secs = [h["sec"] for h in steps if h["synced"] is synced]
        if secs:
            mean = sum(secs) / len(secs)
            print(f"{'sync' if synced else 'local'} steps: {len(secs)}, "
                  f"{mean:.4f} s mean, {tokens / mean:.1f} tokens/s")
    line = f"{cfg.name}: {args.steps} steps, {wall:.2f} s"
    if dev.type == "cuda":
        line += (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on "
                 f"{torch.cuda.get_device_name(dev)}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
