"""Serving-traffic arrival processes: declarative rates, Poisson tapes.

The paper bills every fault-tolerance approach in makespan terms; a
decode fleet serving millions of users is judged on availability and
tail latency instead (Treaster, cs/0501002 frames recovery cost as lost
*service*). This module is the demand side of that billing: a
:class:`TrafficSpec` describes the offered request rate over the
campaign horizon — a constant base, an optional diurnal sinusoid, and
burst overlays — and :func:`compile_request_tape` pre-samples the
Poisson arrival counts per accounting interval into a padded/masked
:class:`RequestTape`, in the same schedule-order rng idiom as the event
tapes' repair draws (``default_rng((seed, STREAM))`` consumed in
interval order), so the reference engine and the batched replay path
bill the identical arrivals by construction.

Everything here is plain numpy — the SLO fold (``traffic/slo.py``, a
later slice of the port) is host-side accounting on both the engine and
replay paths, so the tape never reaches the device.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple

import numpy as np

#: rng stream constant for arrival tapes (the repair-draw stream is
#: ``0x5EED``; request tapes get their own so the two never alias)
ARRIVAL_STREAM = 0x7A9E

#: request tapes pad their interval axis to a multiple of this (uniform
#: with the event tapes' slot padding)
TAPE_PAD = 8


@dataclass(frozen=True)
class TrafficSpec:
    """Declarative offered-load model for one serving campaign.

    The instantaneous rate at time ``t`` (seconds into the horizon) is::

        rate_rps(t) = base_rps * (1 + diurnal_frac * sin(2*pi*(t - diurnal_phase_s)
                                                         / diurnal_period_s))
                      + sum(extra_rps for bursts active at t)

    clipped at zero. ``bursts`` is a tuple of ``(t0_s, duration_s,
    extra_rps)`` overlays. ``requests_per_step`` converts the workload's
    ``step_time(n_shards)`` surface into serving capacity: one shard
    retires that many requests per synchronous decode step.

    ``dt_s`` is the accounting-interval width of the compiled tape and of
    the SLO queue fold; ``queue_wait_cap_s`` is the admission bound —
    requests that would wait longer than this are dropped (shed) rather
    than queued. ``autoscaler`` names the default capacity policy from
    the autoscaler registry (``traffic/registry.py``, a later slice of the
    port; campaign calls may override it).
    """

    base_rps: float = 100.0
    diurnal_frac: float = 0.0
    diurnal_period_s: float = 86400.0
    diurnal_phase_s: float = 0.0
    bursts: Tuple[Tuple[float, float, float], ...] = ()
    requests_per_step: float = 32.0
    dt_s: float = 60.0
    queue_wait_cap_s: float = 120.0
    autoscaler: str = "static"

    def __post_init__(self):
        if self.base_rps < 0:
            raise ValueError(f"base_rps must be >= 0, got {self.base_rps}")
        if not 0.0 <= self.diurnal_frac <= 1.0:
            raise ValueError(
                f"diurnal_frac must be in [0, 1], got {self.diurnal_frac}"
            )
        if self.diurnal_period_s <= 0:
            raise ValueError(f"diurnal_period_s must be > 0, got {self.diurnal_period_s}")
        if self.dt_s <= 0:
            raise ValueError(f"dt_s must be > 0, got {self.dt_s}")
        if self.queue_wait_cap_s <= 0:
            raise ValueError(
                f"queue_wait_cap_s must be > 0, got {self.queue_wait_cap_s}"
            )
        if self.requests_per_step <= 0:
            raise ValueError(
                f"requests_per_step must be > 0, got {self.requests_per_step}"
            )
        # normalise bursts (JSON round-trips tuples as lists) and validate
        bursts = tuple(
            (float(b[0]), float(b[1]), float(b[2])) for b in self.bursts
        )
        for t0_s, duration_s, extra_rps in bursts:
            if duration_s < 0:
                raise ValueError(f"burst duration_s must be >= 0, got {duration_s}")
            if extra_rps < 0:
                raise ValueError(f"burst extra_rps must be >= 0, got {extra_rps}")
        object.__setattr__(self, "bursts", bursts)

    # ------------------------------------------------------------- rates
    def rate_rps(self, t) -> np.ndarray:
        """Instantaneous offered rate at ``t`` (vectorised, float64)."""
        t = np.asarray(t, np.float64)
        r = self.base_rps * (
            1.0
            + self.diurnal_frac
            * np.sin(2.0 * np.pi * (t - self.diurnal_phase_s) / self.diurnal_period_s)
        )
        for t0_s, duration_s, extra_rps in self.bursts:
            r = r + np.where((t >= t0_s) & (t < t0_s + duration_s), extra_rps, 0.0)
        return np.maximum(r, 0.0)

    def expected_requests(self, horizon_s: float) -> float:
        """Closed-form integral of the rate over ``[0, horizon_s)``.

        Exact because ``diurnal_frac <= 1`` and burst overlays are
        non-negative, so the pre-clip rate never goes below zero — the
        analytic anchor the arrival-statistics tests compare Poisson
        tape totals against."""
        T = float(horizon_s)
        w = 2.0 * np.pi / self.diurnal_period_s
        # integral of base * (1 + frac * sin(w (t - phase))) over [0, T]
        total = self.base_rps * T + self.base_rps * self.diurnal_frac / w * (
            np.cos(w * (0.0 - self.diurnal_phase_s)) - np.cos(w * (T - self.diurnal_phase_s))
        )
        for t0_s, duration_s, extra_rps in self.bursts:
            overlap_s = max(0.0, min(T, t0_s + duration_s) - max(0.0, t0_s))
            total += extra_rps * overlap_s
        return float(total)

    # --------------------------------------------------------------- DSL
    def to_dict(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "TrafficSpec":
        d = dict(d)
        bursts = d.get("bursts")
        if bursts is not None:
            d["bursts"] = tuple(tuple(b) for b in bursts)
        return TrafficSpec(**d)


@dataclass(frozen=True)
class RequestTape:
    """Pre-sampled Poisson arrivals on the accounting-interval grid.

    Parallel arrays over intervals, padded to a multiple of ``TAPE_PAD``
    (padding rows: ``valid=False``, ``start_s=inf``, zero width/rate/
    counts — uniform with the event tapes' masked slot padding). The
    tape depends only on ``(spec, horizon, seed)``: tiling and device
    sharding of the replay kernel never touch it, which is what the
    determinism-across-``tile_slots``/``n_devices`` tests pin down.
    """

    seed: int
    dt_s: float
    start_s: np.ndarray  # float64 [n] interval start (inf on padding)
    width_s: np.ndarray  # float64 [n] interval width (0 on padding)
    rate_rps: np.ndarray  # float64 [n] offered rate at the interval midpoint
    counts: np.ndarray  # int64   [n] Poisson arrival count
    valid: np.ndarray  # bool    [n]

    @property
    def n_intervals(self) -> int:
        return int(self.valid.sum())

    @property
    def offered(self) -> int:
        """Total requests offered over the horizon."""
        return int(self.counts[self.valid].sum())


def compile_request_tape(
    traffic: TrafficSpec, horizon_s: float, seed: int = 0
) -> RequestTape:
    """Sample one trial's arrival counts onto the interval grid.

    One Poisson draw per interval with mean ``rate(midpoint) * width``,
    drawn in interval order from ``default_rng((seed, ARRIVAL_STREAM))``
    — the schedule-order idiom the repair-draw and verdict tapes use, so
    a given ``(traffic, horizon, seed)`` always yields the identical
    tape no matter which consumer compiles it."""
    T = float(horizon_s)
    n_iv = max(int(np.ceil(T / traffic.dt_s)), 1)
    start = np.arange(n_iv, dtype=np.float64) * traffic.dt_s
    width = np.minimum(traffic.dt_s, T - start)
    mid = start + 0.5 * width
    rate = traffic.rate_rps(mid)
    rng = np.random.default_rng((int(seed), ARRIVAL_STREAM))
    counts = rng.poisson(rate * width).astype(np.int64)

    n_pad = (-n_iv) % TAPE_PAD
    if n_pad:
        start = np.concatenate([start, np.full(n_pad, np.inf, np.float64)])
        width = np.concatenate([width, np.zeros(n_pad, np.float64)])
        rate = np.concatenate([rate, np.zeros(n_pad, np.float64)])
        counts = np.concatenate([counts, np.zeros(n_pad, np.int64)])
    valid = np.arange(n_iv + n_pad) < n_iv
    return RequestTape(
        seed=int(seed),
        dt_s=float(traffic.dt_s),
        start_s=start,
        width_s=width,
        rate_rps=rate,
        counts=counts,
        valid=valid,
    )
