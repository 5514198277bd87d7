"""Deterministic, seeded fault injection for distributed training.

The async/decentralized strategies this repo reproduces exist to tolerate
real clusters — learners that straggle, slow down heterogeneously, stall
on heavy-tailed pauses, drop gossip payloads, and die mid-run
(1904.04956's AD-PSGD experiments, 2110.11199's asynchronous decentralized
acoustic-model training).  This module is the single source of those
conditions: a :class:`FaultPlan` is a *pure function of its seed* that
schedules every fault, so a run under a plan is exactly reproducible and
two strategies compared under the same plan see the same cluster weather.

The plan is consumed at two boundaries:

* **The step loop** (``repro.core.strategies.make_elastic_train_step`` /
  ``repro.launch.train --fault-*``): :meth:`FaultPlan.step_inputs` yields
  per-step numpy masks — which learners are alive, which contribute a
  gradient this step (stragglers/stalls), who rejoins, which gossip edges
  deliver, whose payloads are corrupted — that are fed to the jitted
  elastic step as plain arrays (constant shapes, one compile).
* **The perfsim boundary** (``benchmarks/perfsim``): the same plan's
  :meth:`speed_factors` / :meth:`stall_extra` / departure schedule drive
  the discrete-event wall-clock simulator at pod-scale learner counts,
  so convergence (real training) and throughput (simulated cluster) are
  reported under ONE fault description.

Faults modeled (all per-learner, all deterministic from ``seed``):

* **stragglers** — heterogeneous speed: a learner with factor ``m``
  computes a gradient only every ``m``-th step (step-loop view) / takes
  ``m×`` the base per-batch time (perfsim view).
* **heavy-tailed stalls** — with ``stall_prob`` per step a learner
  freezes for a Pareto(``stall_shape``)-distributed number of steps
  (GC pauses, network hiccups, preemptions).
* **departures** — a learner crashes at ``step`` and optionally rejoins
  at ``rejoin``; rejoiners are re-seeded from the survivors' consensus
  (elastic membership; docs/fault_tolerance.md).
* **dropped gossip** — with ``drop_prob`` an undirected mixing edge
  fails for the step (both endpoints fall back to themselves; the
  mixing matrix stays doubly stochastic).
* **corrupted gossip** — with ``corrupt_prob`` a learner's *outgoing*
  payload picks up Gaussian noise of relative scale ``corrupt_scale``
  for one step (receivers only; the local replica stays clean).

The plan REFUSES to leave the cluster empty: a schedule under which no
learner is alive at some step raises at construction — the step loop
would otherwise divide by a zero frame count (see
``strategies.check_active``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Straggler:
    """Learner ``learner`` runs ``factor``× slower than the base rate:
    it contributes a gradient only on steps where
    ``(step + phase) % factor == 0``."""

    learner: int
    factor: int
    phase: int = 0


@dataclass(frozen=True)
class Departure:
    """Learner ``learner`` crashes at the start of ``step``; with
    ``rejoin >= 0`` it re-enters at that step (re-seeded from the
    survivors' consensus), otherwise it is gone for good."""

    learner: int
    step: int
    rejoin: int = -1


@dataclass
class FaultPlan:
    """One deterministic cluster-weather schedule (module docstring)."""

    n_learners: int
    seed: int = 0
    stragglers: Tuple[Straggler, ...] = ()
    departures: Tuple[Departure, ...] = ()
    drop_prob: float = 0.0
    stall_prob: float = 0.0
    stall_shape: float = 1.5     # Pareto tail index of stall lengths
    stall_max: int = 64          # cap on a single stall, in steps
    corrupt_prob: float = 0.0
    corrupt_scale: float = 0.0   # noise RMS relative to the payload RMS

    def __post_init__(self):
        L = self.n_learners
        if L < 1:
            raise ValueError(f"fault plan needs n_learners >= 1, got {L}")
        for s in self.stragglers:
            if not 0 <= s.learner < L:
                raise ValueError(f"straggler learner {s.learner} out of "
                                 f"range for n_learners={L}")
            if s.factor < 1:
                raise ValueError(f"straggler factor must be >= 1, "
                                 f"got {s.factor} (learner {s.learner})")
        for d in self.departures:
            if not 0 <= d.learner < L:
                raise ValueError(f"departure learner {d.learner} out of "
                                 f"range for n_learners={L}")
            if d.rejoin >= 0 and d.rejoin <= d.step:
                raise ValueError(
                    f"learner {d.learner} rejoin step {d.rejoin} must be "
                    f"after its crash step {d.step}")
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob must be in [0, 1], "
                             f"got {self.drop_prob}")
        if not 0.0 <= self.stall_prob <= 1.0:
            raise ValueError(f"stall_prob must be in [0, 1], "
                             f"got {self.stall_prob}")
        if not 0.0 <= self.corrupt_prob <= 1.0:
            raise ValueError(f"corrupt_prob must be in [0, 1], "
                             f"got {self.corrupt_prob}")
        self._validate_membership()
        # lazily-grown stall bitmap cache: (horizon, bool (L, horizon))
        self._stalls = None

    # -- membership ------------------------------------------------------
    def _validate_membership(self):
        """No step may leave zero learners alive — the all-inactive edge
        would turn frame-weighted aggregation into 0/0 downstream, so it
        is rejected HERE, with the offending step named."""
        events = sorted({0}
                        | {d.step for d in self.departures}
                        | {d.rejoin for d in self.departures if d.rejoin >= 0})
        for step in events:
            n = int(self.active_at(step).sum())
            if n == 0:
                raise ValueError(
                    f"fault plan leaves ZERO active learners at step {step} "
                    f"(of {self.n_learners}); every step needs at least one "
                    f"survivor — stagger the departures or add rejoins")

    def active_at(self, step: int) -> np.ndarray:
        """bool (L,): alive at ``step`` (crashed learners are inactive in
        [step, rejoin); rejoin < 0 means gone forever)."""
        active = np.ones(self.n_learners, bool)
        for d in self.departures:
            if d.step <= step and (d.rejoin < 0 or step < d.rejoin):
                active[d.learner] = False
        return active

    def rejoin_at(self, step: int) -> np.ndarray:
        """bool (L,): re-enters the cluster exactly at ``step`` (its
        params are re-seeded from the survivors' consensus)."""
        out = np.zeros(self.n_learners, bool)
        for d in self.departures:
            if d.rejoin == step:
                out[d.learner] = True
        return out

    # -- stragglers / stalls --------------------------------------------
    def speed_factors(self) -> np.ndarray:
        """f64 (L,): per-learner slowdown multipliers (1.0 = nominal) —
        the perfsim view of the straggler schedule."""
        f = np.ones(self.n_learners)
        for s in self.stragglers:
            f[s.learner] = max(f[s.learner], float(s.factor))
        return f

    def _straggler_contrib(self, step: int) -> np.ndarray:
        c = np.ones(self.n_learners, bool)
        for s in self.stragglers:
            c[s.learner] &= ((step + s.phase) % s.factor) == 0
        return c

    def _stall_bitmap(self, horizon: int) -> np.ndarray:
        """bool (L, horizon): stalled-at-step, built deterministically by
        walking each learner's seeded stall process (cached, regrown by
        doubling so step_inputs(k) is O(1) amortized)."""
        if self._stalls is not None and self._stalls.shape[1] > horizon:
            return self._stalls
        h = 256
        while h <= horizon:
            h *= 2
        L = self.n_learners
        out = np.zeros((L, h), bool)
        if self.stall_prob > 0:
            for i in range(L):
                r = np.random.default_rng(
                    (np.uint64(self.seed), np.uint64(i), np.uint64(11)))
                s = 0
                while s < h:
                    if r.random() < self.stall_prob:
                        n = int(min(self.stall_max,
                                    np.ceil(r.pareto(self.stall_shape) + 1)))
                        out[i, s:s + n] = True
                        s += n
                    else:
                        s += 1
        self._stalls = out
        return out

    def stalled_at(self, step: int) -> np.ndarray:
        if self.stall_prob <= 0:
            return np.zeros(self.n_learners, bool)
        return self._stall_bitmap(step)[:, step]

    def stall_extra(self, learner: int, k: int) -> float:
        """Extra stall time (in units of the base per-batch time) charged
        to learner ``learner``'s ``k``-th batch — the perfsim view of the
        same heavy-tailed stall process."""
        if self.stall_prob <= 0:
            return 0.0
        r = np.random.default_rng((np.uint64(self.seed), np.uint64(learner),
                                   np.uint64(k), np.uint64(13)))
        if r.random() >= self.stall_prob:
            return 0.0
        return float(min(self.stall_max,
                         np.ceil(r.pareto(self.stall_shape) + 1)))

    # -- gossip faults ---------------------------------------------------
    def edge_ok_at(self, step: int) -> np.ndarray:
        """f32 (L, L): 1 where the undirected mixing edge (i, j) delivers
        this step, 0 where it is dropped (symmetric, diag always 1)."""
        L = self.n_learners
        if self.drop_prob <= 0:
            return np.ones((L, L), np.float32)
        r = np.random.default_rng(
            (np.uint64(self.seed), np.uint64(step), np.uint64(17)))
        up = (r.random((L, L)) >= self.drop_prob)
        ok = np.triu(up, 1)
        ok = (ok + ok.T).astype(np.float32)
        np.fill_diagonal(ok, 1.0)
        return ok

    def corrupt_at(self, step: int) -> np.ndarray:
        """f32 (L,): relative noise scale applied to each learner's
        OUTGOING payload this step (0 = clean)."""
        L = self.n_learners
        if self.corrupt_prob <= 0 or self.corrupt_scale <= 0:
            return np.zeros(L, np.float32)
        r = np.random.default_rng(
            (np.uint64(self.seed), np.uint64(step), np.uint64(19)))
        hit = r.random(L) < self.corrupt_prob
        return (hit * self.corrupt_scale).astype(np.float32)

    # -- the step-loop contract -----------------------------------------
    def step_inputs(self, step: int) -> dict:
        """Everything the elastic train step needs for one step, as
        constant-shape numpy arrays (one jit compile for the whole run):

        ========== ========= =============================================
        key        shape     meaning
        ========== ========= =============================================
        active     (L,) f32  1 = alive this step
        contrib    (L,) f32  1 = computes a gradient this step (alive,
                             straggler-phase hit, not stalled)
        rejoin     (L,) f32  1 = re-enters THIS step (consensus re-seed)
        edge_ok    (L,L) f32 1 = the undirected gossip edge delivers
        corrupt    (L,) f32  outgoing-payload noise scale (0 = clean)
        ========== ========= =============================================
        """
        active = self.active_at(step)
        contrib = active & self._straggler_contrib(step) \
            & ~self.stalled_at(step)
        return {
            "active": active.astype(np.float32),
            "contrib": contrib.astype(np.float32),
            "rejoin": self.rejoin_at(step).astype(np.float32),
            "edge_ok": self.edge_ok_at(step),
            "corrupt": self.corrupt_at(step),
        }

    def no_fault_inputs(self) -> dict:
        """The trivial (fault-free) step inputs — what a plan-less elastic
        step sees."""
        L = self.n_learners
        ones = np.ones(L, np.float32)
        return {"active": ones, "contrib": ones.copy(),
                "rejoin": np.zeros(L, np.float32),
                "edge_ok": np.ones((L, L), np.float32),
                "corrupt": np.zeros(L, np.float32)}

    # -- (de)serialization ----------------------------------------------
    def to_dict(self) -> dict:
        """JSON-able plan description (the schema documented in
        docs/fault_tolerance.md)."""
        return {
            "n_learners": self.n_learners, "seed": self.seed,
            "stragglers": [[s.learner, s.factor, s.phase]
                           for s in self.stragglers],
            "departures": [[d.learner, d.step, d.rejoin]
                           for d in self.departures],
            "drop_prob": self.drop_prob, "stall_prob": self.stall_prob,
            "stall_shape": self.stall_shape, "stall_max": self.stall_max,
            "corrupt_prob": self.corrupt_prob,
            "corrupt_scale": self.corrupt_scale,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            n_learners=d["n_learners"], seed=d.get("seed", 0),
            stragglers=tuple(Straggler(*s) for s in d.get("stragglers", ())),
            departures=tuple(Departure(*x) for x in d.get("departures", ())),
            drop_prob=d.get("drop_prob", 0.0),
            stall_prob=d.get("stall_prob", 0.0),
            stall_shape=d.get("stall_shape", 1.5),
            stall_max=d.get("stall_max", 64),
            corrupt_prob=d.get("corrupt_prob", 0.0),
            corrupt_scale=d.get("corrupt_scale", 0.0),
        )

    def describe(self) -> str:
        bits = [f"L={self.n_learners}", f"seed={self.seed}"]
        if self.stragglers:
            bits.append("stragglers=" + ",".join(
                f"{s.learner}:{s.factor}x" for s in self.stragglers))
        if self.departures:
            bits.append("departures=" + ",".join(
                f"{d.learner}@{d.step}"
                + (f"->{d.rejoin}" if d.rejoin >= 0 else "->never")
                for d in self.departures))
        for k in ("drop_prob", "stall_prob", "corrupt_prob"):
            v = getattr(self, k)
            if v > 0:
                bits.append(f"{k}={v}")
        return "FaultPlan(" + ", ".join(bits) + ")"


# ---------------------------------------------------------------------------
# CLI spec parsing (the --fault-* train flags)
# ---------------------------------------------------------------------------

def parse_stragglers(spec: str) -> Tuple[Straggler, ...]:
    """``"0:4,3:2"`` -> learner 0 at 4x, learner 3 at 2x."""
    out = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        fields = part.split(":")
        if len(fields) != 2:
            raise ValueError(
                f"bad straggler spec {part!r}: want 'learner:factor' "
                f"(e.g. '0:4' = learner 0 runs 4x slower)")
        out.append(Straggler(int(fields[0]), int(fields[1])))
    return tuple(out)


def parse_departures(spec: str) -> Tuple[Departure, ...]:
    """``"1:30:60,2:50"`` -> learner 1 crashes at step 30 and rejoins at
    60; learner 2 crashes at step 50 and never comes back."""
    out = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise ValueError(
                f"bad departure spec {part!r}: want 'learner:step' or "
                f"'learner:step:rejoin' (e.g. '1:30:60')")
        rejoin = int(fields[2]) if len(fields) == 3 else -1
        out.append(Departure(int(fields[0]), int(fields[1]), rejoin))
    return tuple(out)
