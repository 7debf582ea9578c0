"""Adaptive per-session consistency controller (ε-greedy bandit; port of
``repro.policy.controller``).

The control loop, once per merge epoch:

  1. :meth:`AdaptiveController.select` scores every (session, level)
     cell — sliding-window telemetry through the SLA scorer — and picks
     each session's level: greedy argmax-utility with an ε-decayed
     uniform exploration arm.  On the card the whole selection (window
     sums, rates, scores, argmax, exploration) is one launch of the
     ``policy_score`` kernel reading the telemetry rings in place
     (``kernels.ops.policy_select``);
  2. the data plane runs the epoch's ops at the selected levels
     (``repro_torch.storage.simulator.run_protocol_adaptive``);
  3. :meth:`AdaptiveController.observe` folds the epoch's measured
     per-session staleness/violation counts into the telemetry window —
     only the cells actually played (bandit feedback).

The reference scans the loop under one ``jit``; here :meth:`run_scan` is
a Python loop over epochs with the windows on the device.  The ring
pointer and the epoch count are host integers, and ``epsilon`` is
computed on the host in f32 (CUDA's ``powf`` promises no bit-equality);
only the comparison ``u < ε`` runs on the device.

Random draws: the reference draws exploration from ``jax.random``, which
torch cannot reproduce.  The explore uniforms and the random arms are an
explicit input here (``draws``), and by default come from a CPU
``torch.Generator`` seeded with ``seed`` (:func:`make_draws`), so the card
and the CPU see the same draws.  With the reference's draws injected,
every other operation is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.cost_model import PAPER_PRICING, PricingScheme
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.policy_score import window_rates
from repro_torch.obs.metrics import window_init, window_record, window_total
from repro_torch.policy import sla as sla_lib
from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig

# Window sums of integer counts are exact in f32 only below 2^24.
EXACT_F32_INT = 1 << 24


def make_draws(seed: int, shape: tuple[int, ...], n_arms: int,
               device: str | torch.device = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """``(explore_u, arm)`` of ``shape``: f32 uniforms in [0, 1) and int32
    arms in [0, n_arms), both drawn on the CPU from one generator seeded
    with ``seed`` (uniforms first), then moved to ``device``."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    u = torch.rand(shape, generator=g, dtype=torch.float32)
    arm = torch.randint(0, n_arms, shape, generator=g, dtype=torch.int32)
    return u.to(device), arm.to(device)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _host_epsilon(eps0: float, eps_decay: float, epoch: int) -> float:
    """``eps0 · eps_decay ** epoch`` in f32 on the host, as the reference
    computes it (bit-equal for the epochs tested), in numpy scalars: a
    selection's one host computation besides its launch."""
    f = np.float32
    return float(f(eps0) * f(eps_decay) ** f(epoch))


def _draws_for(draws, seed: int, shape: tuple[int, ...], n_arms: int, device):
    if draws is None:
        return make_draws(seed, shape, n_arms, device)
    u = _as_f32(draws[0], device)
    arm = torch.as_tensor(draws[1], device=device).to(torch.int32)
    if tuple(u.shape) != shape or tuple(arm.shape) != shape:
        raise ValueError(f"draws must both be {shape}, got {tuple(u.shape)} and "
                         f"{tuple(arm.shape)}")
    return u, arm


class ControllerState(NamedTuple):
    """Telemetry ring buffer + bookkeeping.

    The window holds per-epoch *counts* (not rates): rates are formed at
    scoring time as windowed-sum ratios, so epochs with more traffic
    weigh more, and empty cells are distinguishable (count 0).
    """

    stale_win: torch.Tensor   # (W, S, L) f32 — stale reads observed
    viol_win: torch.Tensor    # (W, S, L) f32 — violations observed
    reads_win: torch.Tensor   # (W, S, L) f32 — reads observed
    ptr: int                  # next ring slot
    epoch: int                # epochs observed so far


class AdaptiveController:
    """ε-greedy per-session level selection against a declarative SLA,
    on ``device`` (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(
        self,
        n_sessions: int,
        sla: sla_lib.SLA,
        *,
        levels: tuple[ConsistencyLevel, ...] = sla_lib.POLICY_LEVELS,
        window: int = 8,
        eps0: float = 0.05,
        eps_decay: float = 0.9,
        margin: float = 0.8,
        cfg: ClusterConfig = PAPER_CLUSTER,
        pricing: PricingScheme = PAPER_PRICING,
        merge_every: int = 8,
        delta: int = 24,
        impl: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.n_sessions = n_sessions
        self.sla = sla
        # The controller targets the SLA with a safety margin on the
        # measured-rate bounds; reported feasibility uses the raw SLA.
        self.target_sla = dataclasses.replace(
            sla,
            max_stale_read_rate=sla.max_stale_read_rate * margin,
            max_violation_rate=sla.max_violation_rate * margin,
        )
        self.levels = tuple(levels)
        self.n_levels = len(self.levels)
        self.window = window
        self.eps0 = eps0
        self.eps_decay = eps_decay
        self.impl = impl
        self.table = sla_lib.level_table(
            self.levels, cfg, pricing, merge_every=merge_every, delta=delta,
            device=self.device,
        )
        self._bounds = sla_lib.sla_bounds(self.target_sla)

    # -- state ----------------------------------------------------------------

    def init(self) -> ControllerState:
        shape = (self.n_sessions, self.n_levels)
        return ControllerState(
            stale_win=window_init(self.window, shape, device=self.device),
            viol_win=window_init(self.window, shape, device=self.device),
            reads_win=window_init(self.window, shape, device=self.device),
            ptr=0,
            epoch=0,
        )

    # -- telemetry ------------------------------------------------------------

    def observe(self, state: ControllerState, *, level_idx, stale, viol,
                reads) -> ControllerState:
        """Fold one epoch of per-session telemetry into the ring (in
        place; see ``obs.metrics.window_record``).  Only the played
        (session, level) cells receive samples; every other cell of the
        slot is zeroed, which is how old evidence ages out."""
        onehot = torch.nn.functional.one_hot(
            level_idx.long(), self.n_levels).to(torch.float32)
        for win, x in ((state.stale_win, stale), (state.viol_win, viol),
                       (state.reads_win, reads)):
            window_record(win, state.ptr, onehot * x.to(torch.float32)[:, None])
        return state._replace(ptr=state.ptr + 1, epoch=state.epoch + 1)

    def aggregate(self, state: ControllerState):
        """Windowed (stale_rate, viol_rate, sample_count), each (S, L)."""
        return window_rates(state.stale_win, state.viol_win, state.reads_win)

    # -- selection ------------------------------------------------------------

    def epsilon(self, state: ControllerState) -> float:
        """The exploration rate of the next selection (an f32 value)."""
        return _host_epsilon(self.eps0, self.eps_decay, state.epoch)

    def scores(self, state: ControllerState, *, read_frac=0.5):
        """(utility, feasible) of every (session, level) cell, (S, L): the
        windowed rates (:meth:`aggregate`) and the target SLA's session
        parameters through the SLA scorer, in one kernel launch on the
        card (``kernels.ops.policy_select``)."""
        return kernel_ops.policy_select(
            state.stale_win, state.viol_win, state.reads_win, self.table,
            self._bounds, read_frac=read_frac, impl=self.impl)

    def select(self, state: ControllerState, explore_u: torch.Tensor,
               arm: torch.Tensor, *, read_frac=0.5) -> torch.Tensor:
        """Each session's level index for the next epoch, (S,) int32:
        ``arm`` where ``explore_u < ε``, the greedy argmax of
        :meth:`scores`' utility elsewhere (ties to the first level and a
        NaN first, as ``jnp.argmax``), in one kernel launch on the card."""
        return kernel_ops.policy_select(
            state.stale_win, state.viol_win, state.reads_win, self.table,
            self._bounds, read_frac=read_frac, explore_u=explore_u, arm=arm,
            epsilon=self.epsilon(state), impl=self.impl)

    # -- convenience ----------------------------------------------------------

    def level_of(self, idx: int) -> ConsistencyLevel:
        return self.levels[idx]

    def run_scan(self, seed: int, telemetry: dict, *, draws=None):
        """Run the full control loop over precomputed per-level telemetry.

        ``telemetry`` holds (E, S, L) ``stale``/``viol`` and (E, S)
        ``reads``/``writes`` counts (numpy or tensors).  Each epoch
        selects levels from the current window and the previous epoch's
        read/write mix (epoch 0 assumes 50/50), plays them by gathering
        the chosen cells, observes the result and prices it with
        ``sla.epoch_cost``.  ``draws`` is ``(explore_u, arm)``, each
        (E, S); ``None`` draws them with :func:`make_draws` from ``seed``.
        Returns the final state and the per-epoch trace (``choice``,
        ``stale``, ``viol``, ``cost``, each (E, S), on the device)."""
        dev = self.device
        stale_e = _as_f32(telemetry["stale"], dev)
        viol_e = _as_f32(telemetry["viol"], dev)
        reads_e = _as_f32(telemetry["reads"], dev)
        writes_e = _as_f32(telemetry["writes"], dev)
        e = stale_e.shape[0]
        if float(reads_e.max()) * self.window >= EXACT_F32_INT:
            raise ValueError("per-epoch read counts are too large for exact f32 "
                             f"window sums (window {self.window})")
        u, arm = _draws_for(draws, seed, (e, self.n_sessions), self.n_levels, dev)
        read_frac_e = reads_e / torch.clamp(reads_e + writes_e, min=1.0)
        # Causal: epoch t is selected on epoch t-1's observed mix.
        read_frac_e = torch.cat([torch.full_like(read_frac_e[:1], 0.5),
                                 read_frac_e[:-1]])
        rows = torch.arange(self.n_sessions, device=dev)
        state = self.init()
        trace = {"choice": [], "stale": [], "viol": [], "cost": []}
        for t in range(e):
            choice = self.select(state, u[t], arm[t], read_frac=read_frac_e[t])
            ci = choice.long()
            stale = stale_e[t][rows, ci]
            viol = viol_e[t][rows, ci]
            state = self.observe(state, level_idx=choice, stale=stale, viol=viol,
                                 reads=reads_e[t])
            cost = sla_lib.epoch_cost(self.table, choice, reads=reads_e[t],
                                      writes=writes_e[t], stale=stale)
            for k, v in (("choice", choice), ("stale", stale), ("viol", viol),
                         ("cost", cost)):
                trace[k].append(v)
        return state, {k: torch.stack(v) for k, v in trace.items()}


class CadenceState(NamedTuple):
    """Gossip-cadence bandit state: the same ring scheme as
    :class:`ControllerState`, one arm per candidate cadence."""

    gb_win: torch.Tensor      # (W, A) f32 — repair + digest GB observed
    stale_win: torch.Tensor   # (W, A) f32 — stale reads observed
    reads_win: torch.Tensor   # (W, A) f32 — reads observed
    played_win: torch.Tensor  # (W, A) f32 — 1 where the arm was played
    ptr: int
    epoch: int


class CadenceController:
    """ε-greedy selection of the gossip cadence under churn.

    Utility per arm is ``−(repair GB/epoch · gb_price + stale rate ·
    stale_penalty)``; unobserved arms score 0 (the maximum), so greedy
    selection probes every cadence once before settling, with an
    ε-decayed uniform exploration arm on top.  ``gb_price`` defaults to
    the pricing scheme's marginal inter-DC rate.  Runs on ``device``
    (``"cuda"`` unless the caller asks for the CPU); draws as
    :class:`AdaptiveController`'s, (E,) each."""

    def __init__(
        self,
        cadences: tuple[int, ...] = (0, 1, 2, 4, 8),
        *,
        window: int = 8,
        eps0: float = 0.1,
        eps_decay: float = 0.9,
        gb_price: float | None = None,
        stale_penalty: float = 0.05,
        pricing: PricingScheme = PAPER_PRICING,
        device: str | torch.device = "cuda",
    ):
        if not cadences or any(c < 0 for c in cadences):
            raise ValueError(f"invalid cadence arms: {cadences}")
        self.device = resolve_device(device)
        self.cadences = tuple(cadences)
        self.n_arms = len(self.cadences)
        self.window = window
        self.eps0 = eps0
        self.eps_decay = eps_decay
        self.stale_penalty = stale_penalty
        if gb_price is None:
            gb_price = pricing.marginal_inter_dc_per_gb()
        self.gb_price = float(gb_price)

    def init(self) -> CadenceState:
        def z():
            return window_init(self.window, (self.n_arms,), device=self.device)

        return CadenceState(gb_win=z(), stale_win=z(), reads_win=z(),
                            played_win=z(), ptr=0, epoch=0)

    def observe(self, state: CadenceState, *, arm, gb, stale, reads) -> CadenceState:
        """Fold one epoch of fleet telemetry into the ring (in place;
        only the played arm's cell gets the sample)."""
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(arm, device=self.device).long(), self.n_arms
        ).to(torch.float32)
        for win, x in ((state.gb_win, gb), (state.stale_win, stale),
                       (state.reads_win, reads)):
            window_record(win, state.ptr,
                          onehot * torch.as_tensor(x, device=self.device).to(torch.float32))
        window_record(state.played_win, state.ptr, onehot)
        return state._replace(ptr=state.ptr + 1, epoch=state.epoch + 1)

    def epsilon(self, state: CadenceState) -> float:
        return _host_epsilon(self.eps0, self.eps_decay, state.epoch)

    def utilities(self, state: CadenceState) -> torch.Tensor:
        """(A,) f32 — negative cost-plus-staleness score per arm; exactly
        0 for unobserved arms."""
        plays = window_total(state.played_win)
        gb_rate = window_total(state.gb_win) / torch.clamp(plays, min=1.0)
        stale_rate = window_total(state.stale_win) / torch.clamp(
            window_total(state.reads_win), min=1.0)
        f = torch.float32
        u = -(gb_rate * torch.tensor(self.gb_price, dtype=f, device=self.device)
              + stale_rate * torch.tensor(self.stale_penalty, dtype=f,
                                          device=self.device))
        return torch.where(plays > 0, u, torch.zeros((), dtype=f, device=self.device))

    def select(self, state: CadenceState, explore_u, arm) -> torch.Tensor:
        """The cadence arm index for the next epoch, () int32."""
        greedy = torch.argmax(self.utilities(state)).to(torch.int32)
        return torch.where(explore_u < self.epsilon(state), arm, greedy)

    def cadence_of(self, idx: int) -> int:
        return self.cadences[idx]

    def run_scan(self, seed: int, telemetry: dict, *, draws=None):
        """The cadence control loop over per-arm telemetry: (E, A)
        ``gb``/``stale`` and (E,) ``reads``.  ``draws`` is ``(explore_u,
        arm)``, each (E,).  Returns the final state and the trace
        (``arm``, ``gb``, ``stale``, each (E,))."""
        dev = self.device
        gb_e = _as_f32(telemetry["gb"], dev)
        stale_e = _as_f32(telemetry["stale"], dev)
        reads_e = _as_f32(telemetry["reads"], dev)
        e = gb_e.shape[0]
        u, arms = _draws_for(draws, seed, (e,), self.n_arms, dev)
        state = self.init()
        trace = {"arm": [], "gb": [], "stale": []}
        for t in range(e):
            arm = self.select(state, u[t], arms[t])
            gb = gb_e[t][arm.long()]
            stale = stale_e[t][arm.long()]
            state = self.observe(state, arm=arm, gb=gb, stale=stale, reads=reads_e[t])
            for k, v in (("arm", arm), ("gb", gb), ("stale", stale)):
                trace[k].append(v)
        return state, {k: torch.stack(v) for k, v in trace.items()}
