"""Serving launcher: session-guaranteed batched generation (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --reduced --device cpu --requests 4 --tokens 8 --level X_STCC

On the card (the default device) it runs the full config; the CPU takes
only ``--reduced`` configs, as the reference does.  Parameters are random,
from the port's initializer: replica ``r`` is published from seed ``r``.
"""

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
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

    model = build_model(cfg)
    with torch.inference_mode():
        eng = ServingEngine(model, ConsistencyLevel[args.level], device=dev)
        for r in range(args.replicas):
            eng.publish(model.init(r, device=dev), version=r + 1)

        shape = dataclasses.replace(
            PREFILL_32K, seq_len=args.prompt_len, global_batch=1)
        for i in range(args.requests):
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            batch = make_batch(cfg, shape, gen, device=dev)
            batch["max_seq"] = args.prompt_len + args.tokens
            session = ServeSession(session_id=i % 3)
            toks, replica = eng.generate(session, batch, n_tokens=args.tokens)
            print(f"request {i} (session {session.session_id}) -> replica "
                  f"{replica}: {toks[0].tolist()}")
    print(f"staleness={eng.staleness_rate():.3f} reroutes={eng.reroutes} "
          f"serves={eng.total_serves}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
