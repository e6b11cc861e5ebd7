"""Scenario registry: named, versioned failure campaigns.

The paper's two evaluation settings are registered first —
``table1_periodic`` / ``table1_random`` (one-hour job, Placentia) and
``table2_random`` (five-hour genome job) — with ``closed_form`` set so
``core/sim.py`` reproduces the published tables bit-for-bit. The remaining
families are the multi-failure refinements the paper leaves to future work;
they run through the event-driven :class:`CampaignEngine`.

Register your own with :func:`register` (callables returning a
:class:`ScenarioSpec`, so every ``get`` hands back a fresh spec).
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.scenarios.spec import FailureProcessSpec, ScenarioSpec
from repro_torch.traffic.arrivals import TrafficSpec

_REGISTRY: Dict[str, Callable[[], ScenarioSpec]] = {}


def register(name: str, factory: Callable[[], ScenarioSpec], overwrite: bool = False):
    if name in _REGISTRY and not overwrite:
        raise KeyError(f"scenario {name!r} already registered")
    _REGISTRY[name] = factory


def get(name: str) -> ScenarioSpec:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(_REGISTRY)}") from None
    return factory()  # outside the try: a factory's own KeyError propagates as-is


def names() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------- paper ---
def _table1_periodic() -> ScenarioSpec:
    """Table 1: 1 h job, checkpoint every hour, one periodic failure 15 min
    after the checkpoint (Placentia, 4 nodes)."""
    return ScenarioSpec(
        name="table1_periodic",
        n_nodes=4,
        n_spares=2,
        horizon_s=3600.0,
        period_s=3600.0,
        processes=[FailureProcessSpec("periodic", {"offset_s": 900.0})],
        closed_form="periodic",
        description="paper Table 1, periodic failure at minute 15",
    )


def _table1_random() -> ScenarioSpec:
    """Table 1: 1 h job, one random failure uniform in the hour."""
    return ScenarioSpec(
        name="table1_random",
        n_nodes=4,
        n_spares=2,
        horizon_s=3600.0,
        period_s=3600.0,
        processes=[FailureProcessSpec("random", {})],
        closed_form="random",
        description="paper Table 1, random failure within the window",
    )


def _table2_random() -> ScenarioSpec:
    """Table 2: 5 h genome job, checkpoint hourly, one random failure per
    window (offset pattern 14 min for the periodic variant)."""
    return ScenarioSpec(
        name="table2_random",
        n_nodes=4,
        n_spares=2,
        horizon_s=5 * 3600.0,
        period_s=3600.0,
        processes=[FailureProcessSpec("random", {})],
        closed_form="random",
        description="paper Table 2, five-hour job, hourly windows",
    )


# ------------------------------------------------- beyond-paper families ---
def _rack_outage() -> ScenarioSpec:
    """Correlated rack-level outage: both nodes of rack 0 fail within a
    minute of each other mid-window (shared PSU/cooling)."""
    return ScenarioSpec(
        name="rack_outage",
        n_nodes=4,
        n_spares=2,
        horizon_s=2 * 3600.0,
        period_s=3600.0,
        racks={0: 0, 1: 0, 2: 1, 3: 1},
        processes=[FailureProcessSpec("rack", {"rack": 0, "t": 1800.0, "spread_s": 60.0})],
        repair_s=1800.0,
        description="correlated rack outage, 2 nodes within 60 s",
    )


def _cascade_spare() -> ScenarioSpec:
    """Failure of the spare: the host the sub-job migrates to fails two
    minutes later, twice over (depth 2 — needs three fresh targets)."""
    return ScenarioSpec(
        name="cascade_spare",
        n_nodes=4,
        n_spares=3,
        horizon_s=2 * 3600.0,
        period_s=3600.0,
        processes=[
            FailureProcessSpec(
                "cascade", {"node": 1, "t": 1200.0, "delay_s": 120.0, "depth": 2}
            )
        ],
        repair_s=3600.0,
        description="cascading failure chasing the migrated sub-job",
    )


def _flaky_node() -> ScenarioSpec:
    """Repeat offender: node 2 fails every 30 min; after max_strikes=2 it is
    blacklisted and its repairs stop mattering."""
    return ScenarioSpec(
        name="flaky_node",
        n_nodes=4,
        n_spares=2,
        horizon_s=3 * 3600.0,
        period_s=3600.0,
        processes=[
            FailureProcessSpec("flaky", {"node": 2, "every_s": 1800.0, "first_t": 900.0})
        ],
        repair_s=600.0,
        max_strikes=2,
        description="flaky repeat-offender node, blacklisted after 2 strikes",
    )


def _spare_exhaustion() -> ScenarioSpec:
    """Burst larger than the spare pool with no repair: the pool drains and
    the campaign is lost part-way (survived=False)."""
    return ScenarioSpec(
        name="spare_exhaustion",
        n_nodes=4,
        n_spares=1,
        horizon_s=2 * 3600.0,
        period_s=3600.0,
        processes=[FailureProcessSpec("burst", {"t": 2700.0, "k": 3})],
        repair_s=None,
        description="3-node burst against a 1-spare pool, no repair",
    )


def _checkpoint_storm() -> ScenarioSpec:
    """Failures landing inside checkpoint creation: the in-flight checkpoint
    is invalidated, so reactive policies lose a full extra window."""
    return ScenarioSpec(
        name="checkpoint_storm",
        n_nodes=4,
        n_spares=2,
        horizon_s=3 * 3600.0,
        period_s=3600.0,
        processes=[FailureProcessSpec("ckpt_window", {"offset_s": 5.0})],
        repair_s=1800.0,
        description="every checkpoint cut is interrupted by a failure",
    )


def _partition_split() -> ScenarioSpec:
    """Network partition: a cut isolates rack 1 (the minority component)
    from minute 25 to minute 75. Under the spec's ``partition-aware``
    placement, the mid-cut failure on the majority side must be re-placed
    *within* its component (migrations cannot cross the cut); after the
    heal, the second failure places freely again."""
    return ScenarioSpec(
        name="partition_split",
        n_nodes=6,
        n_spares=2,
        horizon_s=2 * 3600.0,
        period_s=3600.0,
        racks={0: 0, 1: 0, 2: 0, 3: 1, 4: 1, 5: 1},
        processes=[
            FailureProcessSpec(
                "partition",
                {
                    "t": 1500.0,
                    "duration_s": 3000.0,
                    # spares 6-7 sit on the majority side of the cut
                    "components": {0: 0, 1: 0, 2: 0, 3: 1, 4: 1, 5: 1, 6: 0, 7: 0},
                },
            ),
            FailureProcessSpec(
                "cascade", {"node": 1, "t": 2400.0, "depth": 0, "predictable": True}
            ),
            FailureProcessSpec("cascade", {"node": 3, "t": 5400.0, "depth": 0}),
        ],
        repair_s=1200.0,
        placement="partition-aware",
        description="cut isolates rack 1 for 50 min; failures mid-cut and post-heal",
    )


def _mc_stress() -> ScenarioSpec:
    """Monte-Carlo stress family: a 24-node half-day campaign composing
    per-window random failures, two flaky repeat offenders and a rack
    outage. Big enough that the batched trajectory kernel's speedup over
    the per-seed Python engine loop is unambiguous (the benchmark
    certifies ≥10× on this family)."""
    return ScenarioSpec(
        name="mc_stress",
        n_nodes=24,
        n_spares=8,
        horizon_s=12 * 3600.0,
        period_s=3600.0,
        racks={i: i // 4 for i in range(24)},
        processes=[
            FailureProcessSpec("random", {}),
            FailureProcessSpec("flaky", {"node": 3, "every_s": 2400.0}),
            FailureProcessSpec("flaky", {"node": 17, "every_s": 3000.0}),
            FailureProcessSpec("rack", {"rack": 2, "t": 4 * 3600.0, "spread_s": 120.0}),
        ],
        repair_s=1800.0,
        max_strikes=3,
        description="24 nodes, 12 h: random + 2 flaky + rack outage composed",
    )


def _straggler_drift() -> ScenarioSpec:
    """Stragglers under failure: node 2 degrades to 40 % speed over a
    10-minute ramp and stays slow for 90 minutes — alive, so it keeps its
    shard and paces every synchronous step — while per-window random
    failures continue. Under a straggler-flagging detector
    (``detector="ewma_straggler"``) the engine rebalances work off the
    slow shard part-way into the window, shrinking the slowdown bill."""
    return ScenarioSpec(
        name="straggler_drift",
        n_nodes=6,
        n_spares=2,
        horizon_s=3 * 3600.0,
        period_s=3600.0,
        processes=[
            FailureProcessSpec("random", {}),
            FailureProcessSpec(
                "degrade",
                {"node": 2, "t": 1800.0, "duration_s": 5400.0, "factor": 0.4, "ramp_s": 600.0},
            ),
        ],
        repair_s=1200.0,
        description="degrading-but-alive node slows its shard while failures continue",
    )


def _multi_window_storm() -> ScenarioSpec:
    """Compound campaign: random per-window failures + a rack outage + a
    flaky node, simultaneously (the 'as many scenarios as you can imagine'
    stress case)."""
    return ScenarioSpec(
        name="multi_window_storm",
        n_nodes=6,
        n_spares=3,
        horizon_s=3 * 3600.0,
        period_s=3600.0,
        racks={0: 0, 1: 0, 2: 1, 3: 1, 4: 2, 5: 2},
        processes=[
            FailureProcessSpec("random", {}),
            FailureProcessSpec("rack", {"rack": 1, "t": 5400.0, "spread_s": 45.0}),
            FailureProcessSpec("flaky", {"node": 0, "every_s": 2700.0}),
        ],
        repair_s=1200.0,
        max_strikes=3,
        description="random + rack + flaky processes composed over 3 h",
    )


def _fleet_stress() -> ScenarioSpec:
    """Fleet-scale stress family: 1024 nodes in 64 16-node racks over a
    4-hour campaign, composing two rack-correlated outages, a 12-node
    burst, two flaky repeat offenders and a degrading straggler against a
    64-spare pool. This is the scale regime the rollback-recovery survey
    (cs/0501002) warns about — and the family the benchmark certifies the
    tiled/sharded replay kernel at ≥100× over the per-seed engine loop."""
    return ScenarioSpec(
        name="fleet_stress",
        n_nodes=1024,
        n_spares=64,
        horizon_s=4 * 3600.0,
        period_s=3600.0,
        racks={i: i // 16 for i in range(1024)},
        processes=[
            FailureProcessSpec("rack", {"rack": 7, "t": 3000.0, "spread_s": 120.0}),
            FailureProcessSpec("rack", {"rack": 21, "t": 9000.0, "spread_s": 120.0}),
            FailureProcessSpec("burst", {"t": 5400.0, "k": 12}),
            FailureProcessSpec("flaky", {"node": 100, "every_s": 1800.0}),
            FailureProcessSpec("flaky", {"node": 900, "every_s": 2700.0}),
            FailureProcessSpec(
                "degrade",
                {"node": 37, "t": 6000.0, "duration_s": 3600.0, "factor": 0.5, "ramp_s": 300.0},
            ),
        ],
        repair_s=1800.0,
        max_strikes=3,
        description="1024 nodes, 4 h: 2 rack outages + 12-burst + 2 flaky + degrade",
    )


# ------------------------------------------------ workload-bound families ---
def _genome_campaign() -> ScenarioSpec:
    """The paper's five-hour genome job at campaign scale, billed under its
    jit-calibrated workload model (``workloads/builtin.GenomeSearchWorkload``)
    instead of the analytic scalar record: per-window random failures plus
    one mid-job rack outage, repairs returning nodes to the pool."""
    return ScenarioSpec(
        name="genome_campaign",
        n_nodes=4,
        n_spares=3,
        horizon_s=5 * 3600.0,
        period_s=3600.0,
        racks={0: 0, 1: 0, 2: 1, 3: 1},
        processes=[
            FailureProcessSpec("random", {}),
            FailureProcessSpec("rack", {"rack": 1, "t": 2.5 * 3600.0, "spread_s": 90.0}),
        ],
        repair_s=1800.0,
        workload="genome_search",
        description="paper genome job, calibrated workload, random + rack failures",
    )


def _live_genome_single() -> ScenarioSpec:
    """The live-orchestration certification campaign: a one-hour genome
    job with ONE unannounced mid-run failure (a burst of k=1 at minute
    37.5 — deliberately *between* the 15-minute checkpoint marks, so
    checkpoint-invalidation billing never enters) and a repair returning
    the victim to the pool. Small enough that the orchestrator daemon
    replays it against real worker processes in under a minute of scaled
    wall time; the bench asserts live makespan ≈ engine-predicted
    makespan on this exact (spec, seed) trial."""
    return ScenarioSpec(
        name="live_genome_single",
        n_nodes=4,
        n_spares=2,
        horizon_s=3600.0,
        period_s=900.0,
        processes=[FailureProcessSpec("burst", {"t": 2250.0, "k": 1})],
        repair_s=1200.0,
        workload="genome_search",
        description="live-cert campaign: genome job, single injected mid-window failure",
    )


def _llm_pretrain_storm() -> ScenarioSpec:
    """State-heavy extreme: a data-parallel LLM pre-training fleet whose
    recovery payload is the full optimizer state (``train_llm`` workload —
    checkpoint writes dominate everything), with a flaky host and
    per-window random failures across a six-hour run."""
    return ScenarioSpec(
        name="llm_pretrain_storm",
        n_nodes=8,
        n_spares=3,
        horizon_s=6 * 3600.0,
        period_s=3600.0,
        racks={i: i // 4 for i in range(8)},
        processes=[
            FailureProcessSpec("random", {}),
            FailureProcessSpec("flaky", {"node": 5, "every_s": 5400.0}),
        ],
        repair_s=1800.0,
        max_strikes=3,
        workload="train_llm",
        description="LLM pre-training fleet: random + flaky under optimizer-state recovery",
    )


def _decode_fleet_churn() -> ScenarioSpec:
    """Serving-fleet family: a 256-shard KV-cache decode fleet
    (``serve_decode`` workload — tiny checkpoints, rebalance-sensitive)
    bound to a diurnal+burst request stream, so campaigns are billed for
    request-level SLOs (p50/p99 latency, drops, availability) alongside
    the makespan. Failure side mirrors ``fleet_stress`` at quarter scale:
    one rack outage, an 8-node burst, two flaky repeat offenders and a
    degrading straggler, with fast repairs churning shards through the
    24-spare pool. The traffic model runs the fleet at ~59 % of its
    ~5.2 k rps roofline at trough, ~89 % at the diurnal peak, and
    briefly past 100 % when the burst overlay lands on the peak's
    shoulder — the regime where checkpoint-write stalls (~108 s of
    frozen serving per write at this scale) invert the p99 ordering
    away from the makespan ordering."""
    return ScenarioSpec(
        name="decode_fleet_churn",
        n_nodes=256,
        n_spares=24,
        horizon_s=2 * 3600.0,
        period_s=1800.0,
        racks={i: i // 16 for i in range(256)},
        processes=[
            FailureProcessSpec("rack", {"rack": 3, "t": 2400.0, "spread_s": 90.0}),
            FailureProcessSpec("burst", {"t": 4000.0, "k": 8}),
            FailureProcessSpec("flaky", {"node": 17, "every_s": 1500.0}),
            FailureProcessSpec("flaky", {"node": 203, "every_s": 2100.0}),
            FailureProcessSpec(
                "degrade",
                {"node": 64, "t": 3300.0, "duration_s": 2700.0, "factor": 0.5, "ramp_s": 300.0},
            ),
        ],
        repair_s=900.0,
        max_strikes=4,
        workload="serve_decode",
        traffic=TrafficSpec(
            base_rps=3100.0,
            diurnal_frac=0.5,
            diurnal_period_s=7200.0,
            diurnal_phase_s=1800.0,
            bursts=((3900.0, 600.0, 900.0),),
            requests_per_step=32.0,
            dt_s=60.0,
            queue_wait_cap_s=120.0,
            autoscaler="static",
        ),
        description="256-shard decode-serving fleet: rack + burst + flaky + degrade under diurnal+burst traffic",
    )


for _f in (
    _table1_periodic,
    _table1_random,
    _table2_random,
    _rack_outage,
    _cascade_spare,
    _flaky_node,
    _spare_exhaustion,
    _checkpoint_storm,
    _partition_split,
    _straggler_drift,
    _mc_stress,
    _fleet_stress,
    _multi_window_storm,
    _genome_campaign,
    _live_genome_single,
    _llm_pretrain_storm,
    _decode_fleet_churn,
):
    register(_f().name, _f)
