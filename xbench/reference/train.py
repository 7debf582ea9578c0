"""Plain PyTorch reference of training a decoder-only MoE transformer (the
OLMoE layer) with AdamW on each pod and X-STCC's int8 parameter merge
between pods, written from the architecture's equations.

* **Model.**  Token embedding; per layer a pre-norm causal self-attention
  (RMSNorm scaled by ``1 + w``, rotary embedding on half-split head
  dimensions, softmax in f32) and a pre-norm mixture of experts: a softmax
  router over every expert, the top ``k`` experts of each token (the lower
  index first among equal probabilities) with their probabilities
  renormalized, each expert a SwiGLU, at most ``capacity`` tokens per
  expert (slots taken in token order, the rest dropped), and the
  Switch-style load-balancing term; a final RMSNorm and an untied head.
  The loss is the mean token cross-entropy plus 0.01 times the layers'
  balancing terms.
* **AdamW** per pod: the gradient clipped to a global norm, the moments,
  bias correction, decoupled weight decay on every leaf of two or more
  dimensions, and a linear-warmup cosine learning rate.
* **Merge** every ``delta`` steps: each pod's change from the last merged
  parameters quantized to int8 with one scale per pod and leaf
  (``max |change| / 127``), the pods' dequantized changes averaged and
  added to the last merged parameters, which every pod then takes.

Every matrix product goes through ``matmul``: f32 with TF32 off, or, for
the control, FP8 training's product (e4m3 operands forward, an e5m2
gradient backward, one scale per tensor).  Each parameter the
configuration keeps below f32 is stored as it keeps it: rounded to that
type whenever it is written (the control: to e4m3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


def matmul_f32(a, b):
    return torch.matmul(a, b)


def fp8(x, dtype=torch.float8_e4m3fn):
    """``x`` rounded to a float8 type under one scale (its largest
    magnitude at the type's largest finite value)."""
    scale = x.abs().amax().clamp(min=1e-12) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(F32) * scale


class _MatmulFP8(torch.autograd.Function):
    """FP8 training's product: the operands in e4m3 forward, the incoming
    gradient in e5m2 backward, every product accumulated in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        g = fp8(g, torch.float8_e5m2)
        ga = torch.matmul(g, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), g)
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga.reshape(qa.shape), gb.reshape(qb.shape)


def matmul_fp8(a, b):
    """The control's product (:class:`_MatmulFP8`)."""
    return _MatmulFP8.apply(a, b)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x: (B, S, H, hd) at positions 0 .. S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd))
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, p, cfg, mm, chunk: int = 256):
    b, s, _ = h.shape
    nh, hd = cfg["n_heads"], cfg["head_dim"]
    q = rope(mm(h, p["wq"]).reshape(b, s, nh, hd), cfg["rope_theta"])
    k = rope(mm(h, p["wk"]).reshape(b, s, nh, hd), cfg["rope_theta"])
    v = mm(h, p["wv"]).reshape(b, s, nh, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, H, S, hd)
    outs = []
    for i in range(0, s, chunk):
        sc = mm(q[:, :, i:i + chunk], k.transpose(-1, -2)) / math.sqrt(hd)
        qi = torch.arange(i, min(s, i + chunk), device=h.device)[:, None]
        sc = sc.masked_fill(torch.arange(s, device=h.device)[None, :] > qi, float("-inf"))
        outs.append(mm(torch.softmax(sc, dim=-1), v))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, nh * hd)
    return mm(o, p["wo"])


def capacity(cfg, t: int) -> int:
    c = max(1, int(cfg["capacity_factor"] * t * cfg["top_k"] / cfg["n_experts"]))
    return max(8, (c + 7) // 8 * 8)


def moe(h, p, cfg, mm):
    """(B, S, D) -> (y, balancing term)."""
    b, s, d = h.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    t = b * s
    x = h.reshape(t, d)
    probs = torch.softmax(mm(x, p["router"]), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    aux = e * torch.sum(F.one_hot(top1, e).to(F32).mean(0) * probs.mean(0))
    experts = torch.argsort(-probs.detach(), dim=-1, stable=True)[:, :k]   # (T, k)
    gates = torch.gather(probs, 1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(cfg, t)
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(t, device=h.device).repeat_interleave(k)[order]
    first = torch.searchsorted(se, torch.arange(e, device=h.device))
    pos = torch.arange(t * k, device=h.device) - first[se]
    keep = pos < cap
    buf = x.new_zeros((e, cap, d))
    buf[se[keep], pos[keep]] = x[st[keep]]
    act = F.silu(mm(buf, p["expert_gate"])) * mm(buf, p["expert_up"])
    out = mm(act, p["expert_down"])                         # (E, C, D)
    y = x.new_zeros((t, d))
    gate_of_slot = gates.reshape(-1)[order]
    y = y.index_add(0, st[keep], out[se[keep], pos[keep]] * gate_of_slot[keep][:, None])
    return y.reshape(b, s, d), aux


def layer(x, lp, cfg, mm):
    x = x + attention(rms_norm(x, lp["attn_norm"], cfg["norm_eps"]), lp["attn"], cfg, mm)
    y, aux = moe(rms_norm(x, lp["mlp_norm"], cfg["norm_eps"]), lp["moe"], cfg, mm)
    return x + y, aux


def loss(params, tokens, labels, cfg, mm):
    """Mean token cross-entropy (labels < 0 ignored) + 0.01 x balancing."""
    x = params["embed"][tokens.long()]
    blocks = params["moe_blocks"]
    aux = torch.zeros((), dtype=F32, device=x.device)
    for i in range(blocks["attn_norm"].shape[0]):
        lp = {"attn_norm": blocks["attn_norm"][i], "mlp_norm": blocks["mlp_norm"][i],
              "attn": {n: w[i] for n, w in blocks["attn"].items()},
              "moe": {n: w[i] for n, w in blocks["moe"].items()}}
        x, a = checkpoint(layer, x, lp, cfg, mm, use_reentrant=False)
        aux = aux + a
    ce = checkpoint(head_loss, x, params["final_norm"], params["lm_head"], labels, cfg, mm,
                    use_reentrant=False)
    return ce + 0.01 * aux


def head_loss(x, norm, head, labels, cfg, mm):
    logits = mm(rms_norm(x, norm, cfg["norm_eps"]), head)
    mask = labels >= 0
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return torch.sum(nll * mask) / mask.sum().clamp(min=1)


def leaves(tree) -> list:
    """The leaves, keys in sorted order at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def lr_at(opt: dict, count: int) -> float:
    warm = min(count / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((count - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


class Pod:
    """One pod's parameters (f32 leaves) and AdamW moments; ``store``
    rounds the leaves marked in ``low`` each time they are written."""

    def __init__(self, params: dict, low: list, store=None):
        self.params, self.low, self.store = params, low, store
        self.m = [torch.zeros_like(x) for x in leaves(params)]
        self.v = [torch.zeros_like(x) for x in leaves(params)]
        self.stored()

    def stored(self) -> None:
        if self.store is not None:
            with torch.no_grad():
                for x, low in zip(leaves(self.params), self.low):
                    if low:
                        x.copy_(self.store(x))

    def step(self, tokens, labels, cfg, opt: dict, count: int, mm) -> tuple[float, list]:
        """One AdamW step; returns (loss, each leaf's norm of the clipped
        gradient the moments took)."""
        ps = leaves(self.params)
        for x in ps:
            x.requires_grad_(True)
        with torch.enable_grad():
            total = loss(self.params, tokens, labels, cfg, mm)
            grads = torch.autograd.grad(total, ps)
        with torch.no_grad():
            for x in ps:
                x.requires_grad_(False)
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / norm.clamp(min=1e-9), max=1.0)
            lr = lr_at(opt, count)
            b1c, b2c = 1 - opt["b1"] ** count, 1 - opt["b2"] ** count
            norms = []
            for x, g, m, v in zip(ps, grads, self.m, self.v):
                g = g * scale
                norms.append(float(torch.linalg.vector_norm(g)))
                m.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v.mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                upd = (m / b1c) / (torch.sqrt(v / b2c) + opt["eps"])
                if x.dim() >= 2:
                    upd = upd + opt["weight_decay"] * x
                x.sub_(lr * upd)
        self.stored()
        return float(total.detach()), norms


def int8_merge(pods: list[Pod], anchor: list) -> list:
    """X-STCC's compressed merge, in place on every pod; returns the new
    anchor (each leaf's merged value)."""
    merged_leaves = []
    with torch.no_grad():
        for i, a in enumerate(anchor):
            a = a.to(F32)
            total = torch.zeros_like(a)
            for pod in pods:
                d = leaves(pod.params)[i] - a
                scale = d.abs().amax().clamp(min=1e-12) / 127.0
                total += torch.clamp(torch.round(d / scale), -127, 127) * scale
                del d
            merged = total / len(pods) + a
            del total
            for pod in pods:
                leaves(pod.params)[i].copy_(merged)
            merged_leaves.append(leaves(pods[0].params)[i])
        for pod in pods:
            pod.stored()
    return merged_leaves


def wire_gb(anchor: list, n_pods: int) -> float:
    """X-STCC's billed GB of one int8 merge: each leaf's int8 codes and
    its f32 scale, over a ring all-reduce (2 (P - 1) payloads)."""
    return 2 * (n_pods - 1) * sum(x.numel() + 4 for x in anchor) / 1e9


def run(weights: dict, batches: list, cfg: dict, opt: dict, *, delta: int,
        matmul=matmul_f32, store=None) -> dict:
    """Steps ``0 .. len(batches)-1`` of every pod from ``weights`` (one pod's
    tree, copied to each pod in f32); step ``t`` merges when ``(t + 1) %
    delta == 0``.  ``batches[t]`` = (tokens, labels), each (P, B, S).
    ``store`` rounds every parameter that ``weights`` holds below f32 each
    time it is written (to the configuration's storage type, or the
    control's).  Returns each step's mean
    loss over the pods, each pod's first-step gradient norms by leaf, each
    pod's change of each leaf after the last step, and the merges'
    bookkeeping: their number and their billed inter-pod GB."""
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.to(F32).clone()
                        for k, v in tree.items()}
    n_pods = batches[0][0].shape[0]
    low = [x.dtype != F32 for x in leaves(weights)]
    pods = [Pod(f32(weights), low, store) for _ in range(n_pods)]
    # The last merged parameters: the weights until the first merge.
    anchor = leaves(weights)
    losses, first_norms = [], None
    merges, gb = 0, 0.0
    for t, (tokens, labels) in enumerate(batches):
        out = [pod.step(tokens[j], labels[j], cfg, opt, t + 1, matmul)
               for j, pod in enumerate(pods)]
        losses.append(sum(o[0] for o in out) / n_pods)
        if t == 0:
            first_norms = [o[1] for o in out]
        if (t + 1) % delta == 0:
            gb += wire_gb(anchor, n_pods)
            merged = int8_merge(pods, anchor)
            merges += 1
            later = any((u + 1) % delta == 0 for u in range(t + 1, len(batches)))
            # Kept apart from the pods only while another merge will read it.
            anchor = [x.clone() for x in merged] if later else None
    change = [[float(torch.linalg.vector_norm(x - w.to(F32))) for x, w in
               zip(leaves(pod.params), leaves(weights))] for pod in pods]
    return {"losses": losses, "grad_norms": first_norms, "change": change,
            "sync": {"merges": merges, "inter_pod_gb": gb}}
