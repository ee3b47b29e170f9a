"""Client-selection strategies (paper §3.2-3.3 + literature baselines §4)
— the port of the JAX package's ``core/selection.py``.

Every strategy maps per-client observations to a boolean (C,) selection
mask; ``cohort_from_mask`` gives the fixed-size index form. Rankings sort with
``torch.argsort(stable=True)``: ``jnp.argsort`` is stable, DEEV/ACSP-FL rank
accuracies that tie often, and an unstable sort would pick other clients.
Random draws (FedAvg, PoC, Oort exploration) come from the ported threefry
(``repro_torch.random``) on the key the round hands over, so they are the
JAX package's draws.

Strategies: FedAvgRandom, PowerOfChoice, Oort, DEEV, ACSPFL,
GradImportance, OortWire, OortFair (see the JAX module for the sources).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as prng
from repro_torch.core.decay import phi_decay


class ClientObservations(NamedTuple):
    """Per-client observations available to the server each round."""

    accuracy: torch.Tensor   # (C,) float — distributed-eval accuracy A_i
    loss: torch.Tensor       # (C,) float — local loss
    n_samples: torch.Tensor  # (C,) float — |d_i|
    delay: torch.Tensor      # (C,) float — systemic training delay (Oort)
    wire_bytes: torch.Tensor | None = None   # (C,) codec uplink wire bytes
    update_norm: torch.Tensor | None = None  # (C,) l2 norm of the compressed delta
    participation_count: torch.Tensor | None = None  # (C,) int — times selected


ClientMetrics = ClientObservations


class CohortSelection(NamedTuple):
    """Fixed-size cohort: ``idx`` (K,) client ids, selected first in
    ascending id order, and ``valid`` (K,) whether each lane is selected."""

    idx: torch.Tensor
    valid: torch.Tensor


def cohort_from_mask(mask: torch.Tensor, cohort_size: int) -> CohortSelection:
    """(C,) bool mask -> fixed-size cohort (stable: ids ascend within the
    selected and the unselected group)."""
    idx = torch.argsort((~mask).to(torch.int8), stable=True)[:cohort_size]
    return CohortSelection(idx=idx, valid=mask[idx])


def _keep_lowest(values: torch.Tensor, within: torch.Tensor, k) -> torch.Tensor:
    """Mask keeping the ``k`` lowest ``values`` among ``within`` (clients
    outside ``within`` rank as +inf); ties keep ascending client id."""
    keyed = torch.where(within, values, torch.full_like(values, float("inf")))
    order = torch.argsort(keyed, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=order.device)
    return within & (ranks < k)


def _keep_highest(values: torch.Tensor, within: torch.Tensor, k) -> torch.Tensor:
    return _keep_lowest(-values, within, k)


def _ones(c: int, device) -> torch.Tensor:
    return torch.ones((c,), dtype=torch.bool, device=device)


@dataclasses.dataclass(frozen=True)
class SelectionStrategy:
    """Base class. ``select`` returns a boolean mask of shape (C,)."""

    def select(self, metrics: ClientObservations, t, rng: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class FedAvgRandom(SelectionStrategy):
    """Uniform random selection of ``fraction`` of clients (FedAvg)."""

    fraction: float = 1.0

    def select(self, metrics, t, rng):
        c = metrics.accuracy.shape[0]
        dev = metrics.accuracy.device
        k = max(1, int(round(self.fraction * c)))
        if k >= c:
            return _ones(c, dev)
        scores = prng.uniform(rng, (c,))
        return _keep_lowest(scores, _ones(c, dev), k)


@dataclasses.dataclass(frozen=True)
class PowerOfChoice(SelectionStrategy):
    """Power-of-Choice (Cho et al.): sample d candidates proportional to
    |d_i| (Gumbel top-d), keep the k with the highest local loss."""

    fraction: float = 0.5
    candidate_factor: int = 2

    def select(self, metrics, t, rng):
        c = metrics.loss.shape[0]
        dev = metrics.loss.device
        k = max(1, int(round(self.fraction * c)))
        d = min(c, self.candidate_factor * k)
        p = metrics.n_samples / torch.sum(metrics.n_samples)
        noise = prng.gumbel(rng, (c,))
        cand_score = torch.log(p + 1e-12) + noise
        candidates = _keep_highest(cand_score, _ones(c, dev), d)
        return _keep_highest(metrics.loss, candidates, k)


@dataclasses.dataclass(frozen=True)
class Oort(SelectionStrategy):
    """Oort (Lai et al.): statistical utility x systemic penalty,
    epsilon-greedy exploration, top-k by utility."""

    fraction: float = 0.5
    alpha: float = 2.0
    preferred_delay: float = 1.0
    epsilon: float = 0.1

    def _systemic_penalty(self, metrics) -> torch.Tensor:
        delay = metrics.delay
        # an explicit division: ``scalar / tensor`` is reciprocal-then-scale
        # in torch, one more rounding than jnp's division
        pref = torch.full_like(delay, self.preferred_delay)
        pen = torch.div(pref, torch.clamp_min(delay, 1e-6)) ** self.alpha
        return torch.where(delay > self.preferred_delay, pen, torch.ones_like(pen))

    def _utility(self, metrics, t) -> torch.Tensor:
        loss = torch.clamp_min(metrics.loss, 0.0)
        stat = metrics.n_samples * torch.sqrt(loss**2 + 1e-12)
        return stat * self._systemic_penalty(metrics)

    def select(self, metrics, t, rng):
        c = metrics.loss.shape[0]
        dev = metrics.loss.device
        k = max(1, int(round(self.fraction * c)))
        util = self._utility(metrics, t)
        k_exploit = max(1, int(round((1.0 - self.epsilon) * k)))
        k_explore = k - k_exploit
        exploit = _keep_highest(util, _ones(c, dev), k_exploit)
        if k_explore > 0:
            scores = prng.uniform(rng, (c,))
            keyed = torch.where(exploit, torch.full_like(scores, float("inf")), scores)
            explore = _keep_lowest(keyed, ~exploit, k_explore)
            return exploit | explore
        return exploit


@dataclasses.dataclass(frozen=True)
class DEEV(SelectionStrategy):
    """DEEV (de Souza et al. 2023): accuracy <= mean filter (Eq. 4-5) +
    decay (Eq. 6), keep the phi(S, t) worst clients (Eq. 7)."""

    decay: float = 0.005

    def select(self, metrics, t, rng):
        a = metrics.accuracy
        filtered = a <= torch.mean(a)
        cohort = torch.sum(filtered)
        keep = phi_decay(cohort, t, self.decay)
        return _keep_lowest(a, filtered, keep)


@dataclasses.dataclass(frozen=True)
class ACSPFL(DEEV):
    """ACSP-FL adaptive selection (paper §3.2-3.3): DEEV's selection law;
    the system adds personalization and partial sharing elsewhere."""


def _require(metrics, strategy: str, *fields: str) -> None:
    missing = [f for f in fields if getattr(metrics, f) is None]
    if missing:
        raise ValueError(
            f"{strategy} needs ClientObservations.{'/'.join(missing)}; run it "
            f"through the repro_torch.fl round pipeline, whose codec phase "
            f"fills the wire-cost signals"
        )


@dataclasses.dataclass(frozen=True)
class GradImportance(SelectionStrategy):
    """Compressed-update norm per wire byte, top ``fraction``."""

    fraction: float = 0.5

    def select(self, metrics, t, rng):
        _require(metrics, "grad-importance", "update_norm", "wire_bytes")
        c = metrics.update_norm.shape[0]
        k = max(1, int(round(self.fraction * c)))
        util = metrics.update_norm / torch.clamp_min(metrics.wire_bytes, 1.0)
        return _keep_highest(util, _ones(c, util.device), k)


@dataclasses.dataclass(frozen=True)
class OortWire(Oort):
    """Oort whose systemic term penalizes codec wire bytes above the mean."""

    def _systemic_penalty(self, metrics):
        _require(metrics, "oort-wire", "wire_bytes")
        wb = metrics.wire_bytes
        preferred = torch.mean(wb)
        pen = (preferred / torch.clamp_min(wb, 1e-6)) ** self.alpha
        return torch.where(wb > preferred, pen, torch.ones_like(pen))


@dataclasses.dataclass(frozen=True)
class OortFair(Oort):
    """Oort with a participation-count fairness bonus
    ``1 + fairness * sqrt(log(t + 2) / (1 + participation))``."""

    fairness: float = 1.0

    def _utility(self, metrics, t):
        _require(metrics, "oort-fair", "participation_count")
        part = metrics.participation_count.to(torch.float32)
        tt = (t if torch.is_tensor(t) else torch.full((), t, device=part.device)).to(torch.float32)
        bonus = 1.0 + self.fairness * torch.sqrt(torch.log(tt + 2.0) / (1.0 + part))
        return super()._utility(metrics, t) * bonus


def _pick(cls, names):
    return lambda **kw: cls(**{k: v for k, v in kw.items() if k in names})


_REGISTRY = {
    "fedavg": _pick(FedAvgRandom, ("fraction",)),
    "poc": _pick(PowerOfChoice, ("fraction", "candidate_factor")),
    "oort": _pick(Oort, ("fraction", "alpha", "preferred_delay", "epsilon")),
    "deev": _pick(DEEV, ("decay",)),
    "acsp-fl": _pick(ACSPFL, ("decay",)),
    "grad-importance": _pick(GradImportance, ("fraction",)),
    "oort-wire": _pick(OortWire, ("fraction", "alpha", "epsilon")),
    "oort-fair": _pick(OortFair, ("fraction", "alpha", "epsilon", "fairness")),
}


def get_strategy(name: str, **kwargs) -> SelectionStrategy:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown selection strategy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def register_strategy(name: str, factory) -> None:
    """Register a custom strategy factory under ``name``."""
    _REGISTRY[name.lower()] = factory
