"""Training launcher (port of ``repro.launch.train``).

Picks the arch config, wires the consistency policy, the replicated
checkpoint store and the trainer, and runs the loop; prints the history,
then the step times and, on the card, the peak device memory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --pods 2 --policy X_STCC
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --reduced --device cpu --steps 50 --policy X_STCC --pods 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --pods 2 --policy X_STCC --delta 2 --compress int8 --seq 512 --batch 4

On the card (the default device) it trains any of the ten archs at its
published widths with random weights.  It refuses (exit 2, with the
reason) a run whose pods' training state — parameters, gradients and
AdamW's two moments, per pod — exceeds the card's memory (olmoe-1b-7b
and llama4-maverick at full depth), a sequence that does not fit the
VLM's image prefix or the hybrid and SSM chunk rules, and a batch the
pods do not divide.  The CPU takes only ``--reduced`` configs, as the
reference does.  ``--dry-run`` (the reference's TPU mesh compile) is not
ported.
"""

import argparse
import sys
import time


def train_state_bytes(cfg, pods: int, state_dtype: str = "float32") -> int:
    """Bytes of ``pods`` pods' training state, counted from
    ``abstract_params``: each parameter, its gradient (the parameter's
    dtype) and AdamW's two moments (``state_dtype``), once per pod."""
    import torch

    from repro_torch.models import abstract_params, build_model
    from repro_torch.tree import leaves

    moment = torch.empty((), dtype=getattr(torch, state_dtype)).element_size()
    per_pod = sum(x.numel() * (2 * x.element_size() + 2 * moment)
                  for x in leaves(abstract_params(build_model(cfg))))
    return pods * per_pod


def refusal(cfg, *, seq: int, batch: int, pods: int, memory: int | None,
            state_dtype: str = "float32") -> str | None:
    """Why the launcher cannot train ``cfg`` as asked, or ``None``.
    ``memory`` is the card's in bytes (``None``: not checked)."""
    from repro_torch.models.rwkv6 import CHUNK

    if batch % max(pods, 1):
        return f"a batch of {batch} does not split over {pods} pods"
    if seq <= cfg.n_vis_tokens:
        return (f"{cfg.name}: the sequence ({seq}) must be longer than the "
                f"{cfg.n_vis_tokens}-token image prefix")
    chunk = {"hybrid": cfg.ssm_chunk, "ssm": CHUNK}.get(cfg.family)
    if chunk and seq > chunk and seq % chunk:
        return (f"{cfg.name}: a {seq}-token sequence does not split into chunks "
                f"of {chunk}; pass --seq <= {chunk} or a multiple of it")
    if memory is not None:
        need = train_state_bytes(cfg, pods, state_dtype)
        if need > memory:
            return (f"{cfg.name} ({cfg.n_layers} layers): the training state of "
                    f"{pods} pods (parameters, gradients, AdamW moments) needs "
                    f"{need / 2**30:.1f} GiB, more than the card's "
                    f"{memory / 2**30:.1f} GiB; pass --reduced")
    return None


def device_memory(dev) -> int | None:
    """The card's memory in bytes; ``None`` off the card."""
    import torch

    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


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
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(10, args.steps // 5 + 1),
                      total_steps=args.steps)
    why = refusal(cfg, seq=args.seq, batch=args.batch, pods=args.pods,
                  memory=device_memory(dev), state_dtype=opt.state_dtype)
    if why is None and dev.type == "cpu" and not args.reduced:
        why = "full config on CPU is impractical; pass --reduced"
    if why:
        print(why, file=sys.stderr)
        return 2

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
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
