"""Device operations (kernels, copies, fills) per round of the replay:
those that start in the traced rounds, before the pass's assembly, over
the rounds traced."""


def read(rec):
    t = rec["trace"]
    widths = rec["shape"].get("widths") or []
    if t is None or not t["device"] or not widths:
        return None
    asm = [r[1] for r in t["ranges"] if r[0] == "assemble"]
    end = min(asm) if asm else t["window_us"][1]
    return sum(1 for _, s, _ in t["device"] if s < end) / len(widths)
