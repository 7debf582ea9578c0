"""Serving launcher: session-guaranteed batched generation (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --reduced --device cpu --requests 4 --tokens 8 --level X_STCC

On the card (the default device) it runs the full config of any of the
ten archs whose replicas' parameters fit in the card's memory (all but
llama4-maverick, ~400 B parameters: it needs ``--reduced``); the CPU
takes only ``--reduced`` configs, as the reference does.  Parameters are
random, from the port's initializer: replica ``r`` is published from
seed ``r``.  The prompt defaults to 16 tokens after the VLM's image
prefix; the hybrid and SSM families take a prompt no longer than their
chunk or a multiple of it, as their chunked scans require.
"""

import argparse
import dataclasses
import sys


def _refusal(cfg, prompt_len: int, replicas: int, dev) -> str | None:
    """Why the launcher cannot serve ``cfg`` as asked, or ``None``."""
    import torch

    from repro_torch.models.rwkv6 import CHUNK

    if prompt_len <= cfg.n_vis_tokens:
        return (f"{cfg.name}: the prompt ({prompt_len}) must be longer than the "
                f"{cfg.n_vis_tokens}-token image prefix")
    chunk = {"hybrid": cfg.ssm_chunk, "ssm": CHUNK}.get(cfg.family)
    if chunk and prompt_len > chunk and prompt_len % chunk:
        return (f"{cfg.name}: a {prompt_len}-token prompt does not split into "
                f"chunks of {chunk}; pass --prompt-len <= {chunk} or a multiple of it")
    if dev.type == "cuda":
        need = replicas * cfg.param_count() * torch.empty((), dtype=getattr(
            torch, cfg.dtype)).element_size()
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            return (f"{cfg.name}: {replicas} replicas of {cfg.param_count():,} "
                    f"{cfg.dtype} parameters need {need / 2**30:.1f} GiB, more than "
                    f"the card's {have / 2**30:.1f} GiB; pass --reduced")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt tokens (default: 16 after the VLM's image prefix)")
    ap.add_argument("--level", default="X_STCC")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import PREFILL_32K, get_config, make_batch, reduced
    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import ServeSession, ServingEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    elif dev.type == "cpu":
        print("full config on CPU is impractical; pass --reduced",
              file=sys.stderr)
        return 2

    prompt_len = 16 + cfg.n_vis_tokens if args.prompt_len is None else args.prompt_len
    refusal = _refusal(cfg, prompt_len, args.replicas, dev)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2

    model = build_model(cfg)
    with torch.inference_mode():
        eng = ServingEngine(model, ConsistencyLevel[args.level], device=dev)
        for r in range(args.replicas):
            eng.publish(model.init(r, device=dev), version=r + 1)

        shape = dataclasses.replace(
            PREFILL_32K, seq_len=prompt_len, global_batch=1)
        for i in range(args.requests):
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            batch = make_batch(cfg, shape, gen, device=dev)
            batch["max_seq"] = prompt_len + args.tokens
            session = ServeSession(session_id=i % 3)
            toks, replica = eng.generate(session, batch, n_tokens=args.tokens)
            print(f"request {i} (session {session.session_id}) -> replica "
                  f"{replica}: {toks[0].tolist()}")
    print(f"staleness={eng.staleness_rate():.3f} reroutes={eng.reroutes} "
          f"serves={eng.total_serves}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
