"""The training driver: a model trained on pods that merge their
parameters under X-STCC (``repro_torch.train``).

Set-up makes one pod's weights and every token batch on the device from
the seed (the benchmark's own draws), hands the weights to
``Trainer.init_state(params=...)`` and drives that state through its
first steps with ``Trainer.fns.local_step`` / ``sync_step``, the window's
own calls and feed: a local step, a sync step (the int8 merge and the
store's bookkeeping), a local step.  Those three steps are what the check
compares with the plain reference, and they warm up every shape the window
runs.  The window then steps on from step 3, one synchronize per step, as
``Trainer.run`` does.

The check compares, for the first three steps: each step's loss (the mean
over the pods), each pod's change of every parameter after the three
steps (by leaf), and the merge's bookkeeping (merges, session violations,
audit severity, billed inter-pod GB); it also reads each pod's gradient
as AdamW took it at step 0 (by leaf, from the first moment:
``|m| / (1 - b1)``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from lib import peaks
from reference import train as ref

CHECK_STEPS = 3


MODEL_KEYS = ("d_model", "n_heads", "head_dim", "n_experts", "top_k", "d_ff", "vocab_size",
              "rope_theta", "norm_eps", "capacity_factor")


def model_config(config: dict) -> dict:
    """The sizes the reference reads."""
    return {k: config[k] for k in MODEL_KEYS}


def leaf_specs(config: dict) -> dict:
    """One pod's parameters in the layout the program keeps (layers
    stacked): each leaf's shape and its initial scale (``None``: a norm
    offset, zero, f32; else normal with that standard deviation)."""
    L, d, v = config["n_layers"], config["d_model"], config["vocab_size"]
    q = config["n_heads"] * config["head_dim"]
    e, ff = config["n_experts"], config["d_ff"]
    return {
        "embed": ((v, d), 0.02),
        "final_norm": ((d,), None),
        "lm_head": ((d, v), 0.02),
        "moe_blocks": {
            "attn_norm": ((L, d), None),
            "attn": {"wq": ((L, d, q), d ** -0.5), "wk": ((L, d, q), d ** -0.5),
                     "wv": ((L, d, q), d ** -0.5), "wo": ((L, q, d), q ** -0.5)},
            "mlp_norm": ((L, d), None),
            "moe": {"router": ((L, d, e), d ** -0.5),
                    "expert_gate": ((L, e, d, ff), d ** -0.5),
                    "expert_up": ((L, e, d, ff), d ** -0.5),
                    "expert_down": ((L, e, ff, d), ff ** -0.5)},
        },
    }


def make_weights(config: dict, seed: int, device) -> dict:
    """One pod's weights (:func:`leaf_specs`), drawn on the device from
    ``seed``, one call per leaf, in the configuration's dtype."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    dtype = getattr(torch, config["dtype"])

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, scale = spec
        if scale is None:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    return make(leaf_specs(config))


def make_batch(traffic: dict, vocab: int, n_pods: int, seed: int, step: int, device) -> dict:
    """Step ``step``'s tokens and next-token labels, (pods, rows, seq) int32:
    a Zipf(``zipf_alpha``) unigram draw over the vocabulary in which a
    token repeats the one ``copy_back`` positions earlier with probability
    ``copy_prob``; the last label of each row is -100."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) % (2 ** 31)) * 1_000_003 + step)
    b, s = traffic["global_batch"], traffic["seq_len"]
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    probs = torch.softmax(-traffic["zipf_alpha"] * torch.log(ranks), dim=0)
    base = torch.multinomial(probs, b * s, replacement=True, generator=gen).reshape(b, s)
    copy = torch.rand((b, s), generator=gen, device=device) < traffic["copy_prob"]
    tokens = torch.where(copy, torch.roll(base, traffic["copy_back"], dims=1), base)
    tokens = tokens.to(torch.int32)
    labels = torch.cat([tokens[:, 1:], torch.full((b, 1), -100, dtype=torch.int32,
                                                  device=device)], dim=1)
    split = lambda x: x.reshape(n_pods, b // n_pods, s)
    return {"tokens": split(tokens), "labels": split(labels)}


def step_flops(config: dict, traffic: dict) -> float:
    """Model FLOPs of one step: 6 x the active parameters less the input
    embedding x tokens, plus causal attention's 6 x layers x seq x heads x
    head_dim per token (half the full score matrix, forward and backward)."""
    d, L = config["d_model"], config["n_layers"]
    q = config["n_heads"] * config["head_dim"]
    per_layer = (4 * d * q + d * config["n_experts"]
                 + config["top_k"] * 3 * d * config["d_ff"] + 2 * d)
    n_active = L * per_layer + d * config["vocab_size"] + d
    tokens = traffic["global_batch"] * traffic["seq_len"]
    attn = 6 * L * traffic["seq_len"] * q
    return tokens * (6 * n_active + attn)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.configs import get_config
        from repro_torch.core import policy_for
        from repro_torch.data import DataConfig
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import Trainer, TrainerConfig

        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        model_cfg = dataclasses.replace(
            get_config(config["arch"]), **model_config(config),
            **{k: config[k] for k in ("n_layers", "n_kv_heads", "dtype", "remat")})
        self.opt = config["adamw"]
        self.n_pods = config["n_pods"]
        policy = policy_for(config["level"], delta_steps=config["delta_steps"],
                            compress_inter_pod=config["compress"])
        self.trainer = Trainer(
            model_cfg, DataConfig(vocab_size=config["vocab_size"], seq_len=traffic["seq_len"],
                                  global_batch=traffic["global_batch"]),
            AdamWConfig(**self.opt), policy, TrainerConfig(n_pods=self.n_pods), device=device)
        self.state = self.trainer.init_state(params=make_weights(config, seed, device))
        self.checked = {"losses": []}
        for step in range(CHECK_STEPS):
            metrics = self._step(step)
            self.checked["losses"].append(metrics["loss"])
            if step == 0:
                b1 = self.opt["b1"]
                self.checked["grad_norms"] = torch.stack([
                    torch.stack([torch.linalg.vector_norm(m[j].to(torch.float32)) / (1 - b1)
                                 for m in _leaves(self.state.opt.mu)])
                    for j in range(self.n_pods)])
            if "merges" in metrics:
                self.checked["sync"] = {k: metrics[k] for k in (
                    "merges", "violations", "severity", "inter_pod_gb")}
        w0 = _leaves(make_weights(config, seed, device))
        self.checked["change"] = torch.stack([
            torch.stack([torch.linalg.vector_norm(p[j].to(torch.float32) - w.to(torch.float32))
                         for p, w in zip(_leaves(self.state.params), w0)])
            for j in range(self.n_pods)])
        del w0
        self.step_no = CHECK_STEPS
        self.flops = step_flops(config, traffic)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, step: int) -> dict:
        batch = make_batch(self.traffic, self.cfg["vocab_size"], self.n_pods, self.seed, step,
                           self.device)
        fns = self.trainer.fns
        fn = fns.sync_step if self.trainer.is_sync_step(step) else fns.local_step
        self.state, metrics = fn(self.state, batch)
        return metrics

    # -- the measured window ---------------------------------------------------

    def window(self, seconds: float, spans, profiler=None) -> dict:
        """Steps until ``seconds`` have gone, one synchronize per step.
        With a ``profiler``, ``trace_steps`` steps after the first are
        traced, the deadline notwithstanding."""
        tokens = self.traffic["global_batch"] * self.traffic["seq_len"]
        losses = []
        steps = 0
        self.traced_steps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if profiler is not None and steps == 1:
                profiler.start()
            step = self.step_no
            label = "sync_step" if self.trainer.is_sync_step(step) else "local_step"
            with spans(label):
                metrics = self._step(step)
                self.sync()
            losses.append(metrics["loss"])
            self.step_no += 1
            steps += 1
            if profiler is not None and profiler.active:
                self.traced_steps += 1
                if self.traced_steps == self.traffic["trace_steps"]:
                    profiler.stop()
            tracing = profiler is not None and (profiler.active or steps < 2)
            if time.perf_counter() >= deadline and not tracing:
                break
        if profiler is not None and profiler.active:
            profiler.stop()
        window_s = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"attempted": steps, "failed": failed, "window_s": window_s, "steps": steps,
                "metrics": {"train_tokens_s": steps * tokens / window_s,
                            "mfu.train": 100.0 * steps * self.flops / window_s
                            / peaks.PEAK_BF16_FLOPS}}

    def trace_shape(self) -> dict:
        return {"steps": self.traced_steps, "flops_per_step": self.flops}

    # -- the check -------------------------------------------------------------

    def release(self) -> None:
        """Copy the checked readings to the host and free the device."""
        c = self.checked
        self.host = {
            "losses": [float(x) for x in c["losses"]],
            "grad_norms": c["grad_norms"].cpu().tolist(),
            "change": c["change"].cpu().tolist(),
            "sync": {k: float(v) for k, v in c.get("sync", {}).items()},
        }
        self.state = self.trainer = self.checked = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[tuple[str, float, float]]:
        """(name, number, limit) of each comparison of the program's
        readings with the reference's."""
        want = reference_run(self.cfg, self.traffic, self.seed, self.device)
        return compare(self.host, want, self.cfg)


def reference_run(config: dict, traffic: dict, seed: int, device,
                  matmul=ref.matmul_f32, store=None) -> dict:
    """The plain reference's first steps from the benchmark's weights and
    batches, on ``device``: computed in f32 with TF32 off, each parameter
    stored in the configuration's dtype (or through ``matmul`` and
    ``store``, the control's)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        weights = make_weights(config, seed, device)
        batches = [(b["tokens"], b["labels"]) for b in (
            make_batch(traffic, config["vocab_size"], config["n_pods"], seed, t, device)
            for t in range(CHECK_STEPS))]
        dtype = getattr(torch, config["dtype"])
        return ref.run(weights, batches, model_config(config), config["adamw"],
                       delta=config["delta_steps"], matmul=matmul,
                       store=store or (lambda x: x.to(dtype).to(torch.float32)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def control_checks(config: dict, traffic: dict, seed: int, device) -> list:
    """The control: the reference in the precision below the configuration's
    bf16 (FP8 training's products, the bf16 parameters stored in e4m3),
    put in the program's place and judged as a run is."""
    got = reference_run(config, traffic, seed, device, ref.matmul_fp8, ref.fp8)
    got["sync"] = expected_sync(got)
    return compare(got, reference_run(config, traffic, seed, device), config)


def expected_sync(want: dict) -> dict:
    """The merge's bookkeeping after the checked steps, as the program
    reports it: the reference's merges and billed GB (in f32), and the
    configuration's guarantee: X-STCC's session floors leave no violation
    for the audit to find, so severity 0."""
    s = want["sync"]
    return {"merges": float(s["merges"]), "violations": 0.0, "severity": 0.0,
            "inter_pod_gb": float(torch.tensor(s["inter_pod_gb"], dtype=torch.float32))}


def _leaves(tree) -> list:
    """The leaves, keys in sorted order at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def leaf_gaps(got: list, want: list) -> list[float]:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = sorted(want)[len(want) // 2]
    return [abs(g - w) / max(w, med) for g, w in zip(got, want)]


def readings(got: dict, want: dict) -> dict:
    """Every gap the check can compare: each step's relative loss gap, and
    for the gradient and the change the worst and the median leaf's gap
    over the pods (with the worst leaf's name).  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change."""
    names = leaf_names()
    out = {"loss": [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]}
    for key in ("grad_norms", "change"):
        worst, median, where = 0.0, 0.0, ""
        for pod, (g, w, gn) in enumerate(zip(got[key], want[key], want["grad_norms"])):
            med = sorted(gn)[len(gn) // 2]
            keep = [True] * len(gn) if key == "grad_norms" else [x >= 1e-3 * med for x in gn]
            gaps = [(gap, i) for i, gap in enumerate(leaf_gaps(g, w)) if keep[i]]
            top = max(gaps)
            if top[0] >= worst:
                worst, where = top[0], f"pod {pod} {names[top[1]]}"
            median = max(median, sorted(gaps)[len(gaps) // 2][0])
        out[key] = {"worst": worst, "median": median, "worst_leaf": where}
    return out


def leaf_names() -> list[str]:
    """The leaves' paths, in :func:`_leaves` order."""
    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}/{k}")]
        return [prefix.lstrip("/")]
    return paths(leaf_specs({k: 1 for k in ("n_layers", "d_model", "vocab_size", "n_heads",
                                             "head_dim", "n_experts", "d_ff")}))


def compare(got: dict, want: dict, cfg: dict) -> list:
    limits = cfg["limits"]
    r = readings(got, want)
    print(f"xbench: readings {json.dumps(r)}", file=sys.stderr, flush=True)
    sync = got.get("sync", {})
    sync_gap = sum(sync.get(k) != v for k, v in expected_sync(want).items())
    # The gradient is read, not compared: its worst leaf is the embedding,
    # whose bf16 backward sums in bf16, and no control or fault moves its
    # median leaf past three times the sound runs' (PERF.md).
    return [("loss_gap", max(r["loss"]), limits["loss_gap"]),
            ("update_gap", r["change"]["worst"], limits["update_gap"]),
            ("sync_gap", sync_gap, 0)]

