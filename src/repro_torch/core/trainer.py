"""FTTrainer — the paper's FT approaches bound to a real training loop
(counterpart of ``repro/core/trainer.py``).

The trainer runs an actual train step (``repro_torch.train.step``: the
model's loss, its gradient through the CUDA kernels' backward on the card,
the optimizer update); a virtual cluster of W hosts supervises it. The
fault-tolerance policy is resolved through the ``repro_torch.strategies``
registry (``policy`` is any registered strategy name, the ``"checkpoint"``
alias for the reactive baseline, or ``"none"``); failures are injected at
step boundaries from a FailureModel schedule:

  * predicted failure (the 29 %): the active strategy migrates the full
    training state to a spare/neighbour host BEFORE the failure lands —
    zero lost steps; migration is a real, hash-verified state move.
  * unpredicted failure: the state on the failed host is lost; the policy
    falls back to its reactive backstop — restore the last on-disk
    checkpoint (real file restore) and re-execute the lost steps. This is
    the paper's recommended multi-agent-on-top-of-checkpointing layering
    (Fig 15 a-d all arise).
  * false-positive prediction (precision 64 %): an unnecessary migration —
    the instability cost of Fig 15(c), paid in time but not in state loss.

Because the data pipeline and train step are deterministic (the backward
kernels sum in a fixed order, with no atomics), a run under ANY policy
must end bit-identical to the failure-free run — the trainer's
no-data-loss invariant, asserted via ``tree_hash``.

The step runs eagerly (the reference jits it); each step ends with a
synchronize of the loss's device, where the reference blocks on the loss.
The train step updates the state's tensors in place: every copy the FT
machinery keeps (checkpoints, migrated and pre-staged payloads) is a copy,
never a reference to the live state. ``device`` places the failure
predictor, the detector and the workload's calibration ("cuda" unless the
caller asks for the CPU).
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.checkpoint import AsyncCheckpointer, CheckpointStore
from repro_torch.obs.profile import stopwatch
from repro_torch.core.elastic import replan, reshard_batch
from repro_torch.core.failure import FailureEvent, PREDICTION_LEAD_S, PREDICTION_PRECISION
from repro_torch.core.predictor import FailurePredictor
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.core.straggler import mitigate
from repro_torch.strategies.placement import get_placement
from repro_torch.strategies.registry import get as get_strategy
from repro_torch.telemetry import CompositeDetector, EWMAStragglerDetector, frame_from_heartbeats
from repro_torch.telemetry import resolve as resolve_detector
from repro_torch.utils.tree import tree_hash


@dataclass
class FTReport:
    steps_run: int = 0
    steps_reexecuted: int = 0
    migrations: int = 0
    false_migrations: int = 0
    restores: int = 0
    checkpoints: int = 0
    rebalances: int = 0
    elastic_shrinks: int = 0
    train_time_s: float = 0.0
    step_s: List[float] = field(default_factory=list)  # each executed step's seconds
    ft_time_s: float = 0.0
    sim_wire_s: float = 0.0
    events: List[dict] = field(default_factory=list)
    # typed repro_torch.obs.trace.TraceEvent rows, populated when the trainer
    # was built with trace=True (time axis = the run's simulated seconds)
    trace_events: List[object] = field(default_factory=list)

    @property
    def overhead_fraction(self) -> float:
        return (self.ft_time_s + self.sim_wire_s) / max(self.train_time_s, 1e-9)


class FTTrainer:
    def __init__(
        self,
        train_step: Callable,
        init_state: Callable,
        make_batch: Callable[[int], dict],
        policy: str = "hybrid",  # any registered strategy | "checkpoint" | "none"
        n_hosts: int = 4,
        ckpt_dir: Optional[str] = None,  # default: a fresh directory under $TMPDIR
        ckpt_every: int = 10,
        async_ckpt: bool = False,
        speculative: bool = False,  # pre-stage state in the warning band
        profile: str = "tpu_pod",
        seed: int = 0,
        placement: str = "nearest-spare",
        detector: str = "oracle",  # any registered telemetry detector
        workload: Optional[str] = None,  # a repro_torch.workloads name: paces the
        #   failure time axis from the workload's calibrated step-time surface
        trace: bool = False,  # record typed obs trace events on the report
        device: str = "cuda",  # the predictor's, the detector's and the workload's
    ):
        self.train_step = train_step
        self.init_state = init_state
        self.make_batch = make_batch
        self.policy = policy
        self.placement = get_placement(placement)
        self.rt = ClusterRuntime(
            n_hosts=n_hosts, n_spares=2, profile=profile, seed=seed,
            placement=self.placement,
        )
        self.rt.predictor = FailurePredictor.train(seed=seed, device=device)
        self.store = CheckpointStore(ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
        self.async_ckpt = AsyncCheckpointer(self.store) if async_ckpt else None
        self.ckpt_every = ckpt_every
        self.rng = np.random.default_rng(seed)
        self.state = init_state()
        # the state lives on host 0 initially (the supervised worker)
        self.home = 0
        # the policy string resolves through the strategy registry — no
        # per-policy branching anywhere in the trainer. Registered names
        # always win; "none" and the "<policy>_ref" fallback (failure-free
        # reference-run labels) train without FT; any other unknown name
        # raises rather than silently dropping FT.
        if policy == "none":
            self.strategy = None
        else:
            try:
                self.strategy = get_strategy(policy, placement=self.placement)
            except KeyError:
                if not policy.endswith("_ref"):
                    raise
                self.strategy = None
        if self.strategy is not None:
            self.strategy.attach(self.rt, {self.home: self.state})
        else:
            self.rt.occupy(self.home, self.state, f"{policy}:0")
        # data-parallel work distribution across the virtual hosts (the
        # straggler detector rebalances it; elastic shrink re-plans it)
        self.n_hosts = n_hosts
        self.per_host_batch = [1] * n_hosts
        # observation runs through the unified detector API: the named
        # failure detector (oracle = the pre-refactor schedule/false-alarm
        # semantics, "ml" = inference on the live health logs) composed
        # with the EWMA straggler detector over step latencies
        self.detector_name = detector
        self._straggler = EWMAStragglerDetector(n_hosts=n_hosts + 2)
        self.detector = CompositeDetector(
            [resolve_detector(detector, device), self._straggler]
        ).bind(self.rt)
        self.egress = None
        if speculative:
            from repro_torch.core.speculative import SpeculativeEgress

            self.egress = SpeculativeEgress(self.rt, placement=self.placement)
        # optional workload model: one trainer "step" is one synchronous
        # unit of the workload, so the failure schedule's time axis runs at
        # the workload's calibrated step time instead of the 1 s default
        self.workload = None
        self._workload_step_s = None
        if workload is not None:
            from repro_torch.workloads import resolve as resolve_workload

            self.workload = resolve_workload(workload, device=device)
            table = self.workload.cost_table(profile, n_nodes=n_hosts)
            self._workload_step_s = float(table.step_time(n_hosts))
        # opt-in structured tracing (zero overhead off: recorder is None)
        self.recorder = None
        if trace:
            from repro_torch.obs.trace import TraceRecorder

            self.recorder = TraceRecorder()

    # -- internal ------------------------------------------------------------
    @property
    def _proactive(self) -> bool:
        return self.strategy is not None and self.strategy.proactive

    def _migrate(self) -> dict:
        rep = self.strategy.migrate(self.home)
        self.home = int(rep["to"])
        # state follows the shard on the new host
        self.state = self.rt.hosts[self.home].shard
        self.strategy.sync(self.home, self.state)
        return rep

    def run(
        self, n_steps: int, failures: List[FailureEvent], step_time_s: Optional[float] = None
    ) -> FTReport:
        """step_time_s maps steps onto the failure schedule's time axis
        (default: the workload's calibrated step time when the trainer was
        built with ``workload=``, else 1 s per step)."""
        if step_time_s is None:
            step_time_s = self._workload_step_s if self._workload_step_s else 1.0
        rep = FTReport()
        fq = sorted(failures, key=lambda e: e.t)
        fi = 0
        last_ckpt_step = None
        step = 0
        while step < n_steps:
            now = step * step_time_s

            # --- proactive window: predicted failures + false positives ----
            if self._proactive:
                home_mod = self.home % self.rt.n_active
                # ground truth: the oracle side channel only — inference
                # detectors never see these flags, they read the telemetry
                imminent = (
                    fi < len(fq)
                    and fq[fi].predictable
                    and now >= fq[fi].t - fq[fi].lead_s
                    and fq[fi].node == home_mod
                )
                false_alarm = self.rng.random() < (
                    0.002 * (1 - PREDICTION_PRECISION) / PREDICTION_PRECISION
                )
                if self.detector_name != "oracle":
                    # generative signal: a node emits a degrading signature
                    # through the lead window before a *predictable*
                    # failure — the signal inference detectors learn from
                    # (gated so the oracle path's telemetry draws stay
                    # byte-identical to the pre-detector-API trainer)
                    if (
                        fi < len(fq)
                        and fq[fi].predictable
                        and now >= fq[fi].t - fq[fi].lead_s
                    ):
                        self.rt.heartbeats.mark_degrading(fq[fi].node)
                # real probe of the supervised cluster -> one frame
                feats = self.rt.heartbeats.tick()
                frame = frame_from_heartbeats(
                    self.rt.heartbeats,
                    now,
                    features=feats,
                    oracle={
                        "node": home_mod,
                        "imminent": imminent,
                        "false_alarm": false_alarm,
                        "lead_s": fq[fi].lead_s if fi < len(fq) else PREDICTION_LEAD_S,
                    },
                )
                verdicts = self.detector.observe(now, frame)
                # straggler verdicts: flag hosts whose heartbeat latency
                # drifts, shift their batch share to the healthy ones
                flagged = sorted(
                    {v.node for v in verdicts if v.kind == "straggler" and v.node < self.n_hosts}
                )
                if flagged:
                    new_split = mitigate(self.per_host_batch, flagged)
                    if new_split != self.per_host_batch:
                        self.per_host_batch = new_split
                        rep.rebalances += 1
                        rep.events.append(
                            {"t": now, "kind": "straggler_rebalance", "hosts": flagged}
                        )
                        if self.recorder is not None:
                            self.recorder.emit(
                                now, "rebalance", hosts=tuple(flagged), reason="straggler"
                            )
                predicted = any(
                    v.kind == "failure_predicted" and v.node == home_mod for v in verdicts
                )
                if self.egress is not None:
                    # warning band = failure within 3x the lead window, or a
                    # mildly elevated hazard score on the live telemetry
                    warn = (
                        fi < len(fq)
                        and fq[fi].predictable
                        and now >= fq[fi].t - 3 * fq[fi].lead_s
                    )
                    log = self.rt.heartbeats.logs[self.home % self.rt.n_active]
                    hazard = self.rt.predictor.score(log[-1]) if log else 0.0
                    if warn or hazard >= self.egress.warn_threshold:
                        srep = self.egress.maybe_stage(self.home, self.state, 1.0)
                        if srep:
                            rep.events.append(
                                {"t": now, "kind": "speculative_stage", **srep}
                            )
                if predicted:
                    src = self.home
                    with stopwatch() as sw:
                        if self.egress is not None and self.egress.staged is not None:
                            mrep = self.egress.migrate_prestaged(
                                self.home, self.state, self.state
                            )
                            old_home = self.home
                            self.home = mrep["to"]
                            self.state = self.rt.hosts[self.home].shard
                            self.strategy.rehome(old_home, self.home, self.state)
                            mrep.setdefault("staging_modelled_s", 0.0)
                        else:
                            mrep = self._migrate()
                    rep.ft_time_s += sw.s
                    rep.sim_wire_s += mrep["reinstate_modelled_s"] + mrep["staging_modelled_s"]
                    rep.migrations += 1
                    if self.recorder is not None:
                        self.recorder.emit(
                            now,
                            "migrate",
                            node=src,
                            target=self.home,
                            outcome="migrated",
                            false_claim=not imminent,
                        )
                    # the payload moved and the move's measured seconds
                    moved = {"bytes": mrep.get("bytes", mrep.get("delta_bytes")),
                             "migrate_s": sw.s}
                    if imminent:
                        fi += 1  # failure lands on the now-empty host
                        self.rt.heartbeats.mark_failed(fq[fi - 1].node)
                        rep.events.append({"t": now, "kind": "predicted_failure_avoided",
                                           **moved})
                    else:
                        rep.false_migrations += 1
                        rep.events.append({"t": now, "kind": "false_positive_migration",
                                           **moved})

            # --- unpredicted failure lands -----------------------------------
            if fi < len(fq) and now >= fq[fi].t:
                ev = fq[fi]
                fi += 1
                self.rt.heartbeats.mark_failed(ev.node)
                if self.recorder is not None:
                    self.recorder.emit(
                        now, "failure", node=ev.node, cause=ev.cause,
                        predictable=ev.predictable,
                    )
                if ev.node == self.home % self.rt.n_active:
                    # state lost: reactive backstop
                    with stopwatch() as sw:
                        if self.async_ckpt:
                            self.async_ckpt.wait()
                        lstep = self.store.latest_step()
                        if lstep is None:
                            # strategies that keep no checkpoint cadence (cold
                            # restart, custom no-backstop strategies) restart
                            # from scratch — everything re-executes
                            assert (
                                self.strategy is None
                                or not self.strategy.wants_checkpoints
                            ), "unpredicted failure before first checkpoint"
                            self.state = self.init_state()
                            lstep = 0
                        else:
                            self.state, rrep = self.store.restore(lstep, self.state)
                    rep.ft_time_s += sw.s
                    rep.restores += 1
                    rep.steps_reexecuted += step - lstep
                    step = lstep
                    target = self.placement.pick(self.rt, ev.node)
                    if target is None:
                        # no spare, no healthy neighbour: elastic shrink —
                        # rebalance shards/batch over the survivors
                        alive = [
                            h for h in range(self.n_hosts)
                            if self.rt.healthy(h) and h != ev.node
                        ]
                        self.per_host_batch = reshard_batch(
                            sum(self.per_host_batch), len(alive)
                        )
                        replan(self.n_hosts, alive)
                        rep.elastic_shrinks += 1
                        target = alive[0]
                        rep.events.append({"t": now, "kind": "elastic_shrink",
                                           "alive": alive})
                        if self.recorder is not None:
                            self.recorder.emit(
                                now, "rebalance", hosts=tuple(alive),
                                reason="elastic_shrink",
                            )
                    self.rt.occupy(target, self.state, "restored")
                    old_home, self.home = self.home, target
                    if self.strategy is not None:
                        self.strategy.rehome(old_home, target, self.state)
                    rep.events.append({"t": now, "kind": "unpredicted_failure_restore"})
                    if self.recorder is not None:
                        self.recorder.emit(
                            now, "migrate", node=old_home, target=target,
                            outcome="restored",
                        )
                self.rt.heartbeats.revive(ev.node)  # node returns to pool later

            # --- checkpoint cadence -----------------------------------------
            if (
                self.strategy is not None
                and self.strategy.wants_checkpoints
                and step % self.ckpt_every == 0
            ):
                with stopwatch() as sw:
                    if self.async_ckpt:
                        self.async_ckpt.save_async(
                            self.state, step, incremental_against=last_ckpt_step
                        )
                    else:
                        self.store.save(self.state, step, incremental_against=last_ckpt_step)
                rep.ft_time_s += sw.s
                last_ckpt_step = step
                rep.checkpoints += 1
                if self.recorder is not None:
                    self.recorder.emit(now, "ckpt_write", step=step)

            # --- the real training step --------------------------------------
            with stopwatch() as sw:
                batch = self.make_batch(step)
                self.state, metrics = self.train_step(self.state, batch)
                loss = metrics["loss"]
                if isinstance(loss, torch.Tensor) and loss.is_cuda:
                    torch.cuda.synchronize(loss.device)
            rep.train_time_s += sw.s
            rep.step_s.append(sw.s)
            rep.steps_run += 1
            step += 1
            # keep the shard view in sync (zero-copy reference)
            self.rt.hosts[self.home].shard = self.state
            if self.strategy is not None:
                self.strategy.sync(self.home, self.state)

        if self.async_ckpt:
            self.async_ckpt.wait()
        rep.events.append({"final_hash": tree_hash(self.state)})
        if self.recorder is not None:
            from repro_torch.obs.trace import TraceEvent

            rep.trace_events = sorted(self.recorder.events, key=TraceEvent.sort_key)
        return rep
