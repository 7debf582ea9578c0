"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (port of ``repro.kernels``):

  flash_attention — causal/windowed GQA attention (online softmax).
  vclock_audit    — DUOT pairwise causality audit (paper §3.3).
  vclock_chain    — the serial clock chain of one op batch.
  session_floor   — batched X-STCC session-floor admission check.
  op_ingest       — batched op-ingestion prefixes.
  digest_compare  — gossip range-digest diff.
  histogram       — masked fixed-bin histograms (obs plane).
  placement_score — replica-placement utility per candidate.
  policy_score    — (sessions × levels) SLA scorer.

``ops`` dispatches between each kernel and its plain version.  The
reference's ``ref`` module of oracles has no separate counterpart: each
plain version lives beside its kernel.
"""

from repro_torch.kernels import ops

__all__ = ["ops"]
