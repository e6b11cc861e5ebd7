"""The supervision daemon: the engine's tick loop, run against real processes.

The port of ``repro.orchestrator.daemon``: its workers run
``python -m repro_torch.orchestrator.worker`` on the plan's device, and
the workload's billing and the detector resolve on that device too.
``OrchestratorDaemon`` shepherds one live campaign end to end with zero
manual intervention:

* launches every worker up front — ``n_nodes`` shard holders **plus
  warm spares** that sit idle-but-heartbeating, so a migration lands on
  an already-booted process instead of paying a cold Python/torch spawn
  and a device context on the critical path (the spawn for a *repaired* host happens off the
  critical path, mirroring ``repair_s`` + ``provision_spare``);
* replays the spec's exact compiled failure stream through a registered
  :class:`~repro_torch.orchestrator.injector.Injector` (cascade children chase
  the host their parent's shard migrated to, like the engine);
* detects death three ways — typed exit codes
  (:mod:`~repro_torch.orchestrator.contract`), heartbeat stalls
  (:meth:`HeartbeatService.stalled` with explicit timestamps), and the
  *existing* :class:`~repro_torch.telemetry.detector.Detector` protocol fed
  live :class:`~repro_torch.telemetry.frame.TelemetryFrame` rows (no new
  detection code);
* resolves every failure through the *existing*
  :class:`~repro_torch.strategies.base.FaultToleranceStrategy` +
  :class:`~repro_torch.core.runtime.ClusterRuntime` machinery — strikes,
  blacklisting (optionally TTL'd), spare re-provisioning, exponential
  backoff on respawn — applying the strategy's modelled
  ``reinstate + overhead`` bill as a *scaled stall* before the migrated
  shard resumes, while lost work is real (the target redoes every step
  since the last checkpoint);
* emits the *existing* :mod:`repro_torch.obs.trace` event stream, so a live
  run finalises to a :class:`CampaignTrace` (``source="live"``) and
  exports to Perfetto exactly like a simulated one;
* re-plans at most ``max_replans`` times when the
  :class:`~repro_torch.orchestrator.plan.DriftMonitor` sees the spec lying,
  switching strategy via the planning oracle mid-run.

Everything time-like is injected (``clock``, ``async_sleep``), so the
whole daemon runs subprocess-free under a fake clock
(:mod:`repro_torch.orchestrator.testing`) and in real time under asyncio.

Workers are spawned with :mod:`subprocess` (fork and exec), never a
:mod:`multiprocessing` fork: the daemon's process may already hold a CUDA
context from the plan's calibration, which a forked child cannot use.
"""
from __future__ import annotations

# The reference's wall-clock lint allows an asyncio import (and
# time.monotonic calls) only in paths containing ``repro/orchestrator/``
# (ALLOWED_FRAGMENTS in repro/analysis/rules/wallclock.py), which this
# package's path does not. The other modules here only hold time.monotonic
# as a default clock reference, which the rule allows anywhere.
# repro: ignore-file[no-wallclock-in-sim]

import asyncio
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.failure import FailureEvent
from repro_torch.core.migration import DependencyGraph
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.orchestrator import contract
from repro_torch.orchestrator.plan import DriftMonitor, LivePlan, scale_failure_rate
from repro_torch.orchestrator.spool import Spool


# ------------------------------------------------------------- handles ---
class WorkerHandle:
    """One supervised process, by whatever mechanism runs it."""

    wid: int

    def start(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def poll_exit(self) -> Optional[int]:
        """Exit code if the process has died, else None."""
        raise NotImplementedError  # pragma: no cover - interface

    def deliver(self, action: str) -> None:
        """Signal-level injection ("kill" -> SIGKILL, "stall" -> SIGSTOP)."""
        raise NotImplementedError  # pragma: no cover - interface

    def reap(self) -> None:
        """Force the process dead (SIGCONT + SIGKILL), idempotent."""
        raise NotImplementedError  # pragma: no cover - interface


class SubprocessHandle(WorkerHandle):
    """A real ``python -m repro_torch.orchestrator.worker`` child process."""

    def __init__(self, wid: int, argv: List[str], env: Optional[Dict[str, str]] = None):
        self.wid = int(wid)
        self.argv = list(argv)
        self.env = env
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            self.argv,
            env=self.env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def poll_exit(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    def deliver(self, action: str) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        if action == "kill":
            self.proc.send_signal(signal.SIGKILL)
        elif action == "stall":
            self.proc.send_signal(signal.SIGSTOP)

    def reap(self) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            self.proc.send_signal(signal.SIGCONT)  # a SIGSTOPped child ignores SIGKILL delivery order otherwise
            self.proc.kill()
            self.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):  # pragma: no cover - teardown race
            pass


class SubprocessLauncher:
    """Launches real worker processes sharing one spool directory, each
    running its step program on ``device``. The package's own source
    directory leads the workers' ``PYTHONPATH``, so they import the same
    ``repro_torch`` as the daemon."""

    def __init__(
        self,
        spool: Spool,
        workload: str,
        seed: int,
        python: str = sys.executable,
        abort_after_s: Optional[float] = None,
        device: str = "cuda",
    ):
        self.spool = spool
        self.workload = workload
        self.seed = int(seed)
        self.python = python
        self.abort_after_s = abort_after_s
        self.device = str(device)

    def command(self, wid: int) -> Tuple[List[str], Dict[str, str]]:
        """The argv and the environment worker ``wid`` is started with."""
        argv = [
            self.python, "-m", "repro_torch.orchestrator.worker",
            "--spool", self.spool.root,
            "--worker-id", str(int(wid)),
            "--workload", self.workload,
            "--seed", str(self.seed),
            "--device", self.device,
        ]
        if self.abort_after_s is not None:
            argv += ["--abort-after-s", str(self.abort_after_s)]
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
        return argv, env

    def launch(self, wid: int) -> WorkerHandle:
        argv, env = self.command(wid)
        h = SubprocessHandle(wid, argv, env=env)
        h.start()
        return h


# -------------------------------------------------------------- report ---
@dataclass
class LiveReport:
    """What one supervised campaign actually did, simulator-comparable."""

    scenario: str
    strategy: str  # oracle's launch choice
    final_strategy: str  # after any re-plans
    survived: bool
    live_total_s: Optional[float]  # scaled live makespan
    predicted_total_s: float  # engine bill for the same (spec, seed)
    failed_at_s: Optional[float] = None
    n_events: int = 0
    n_handled: int = 0
    n_migrations: int = 0
    n_blacklisted: int = 0
    n_reprovisioned: int = 0
    n_stalls: int = 0
    n_replans: int = 0
    replans: List[Dict] = field(default_factory=list)
    results: Dict[int, Dict] = field(default_factory=dict)  # shard -> result
    trace: Optional[object] = None  # repro_torch.obs.trace.CampaignTrace

    @property
    def rel_err(self) -> Optional[float]:
        if self.live_total_s is None or self.predicted_total_s <= 0:
            return None
        return abs(self.live_total_s - self.predicted_total_s) / self.predicted_total_s

    def to_dict(self) -> Dict:
        return {
            "scenario": self.scenario,
            "strategy": self.strategy,
            "final_strategy": self.final_strategy,
            "survived": self.survived,
            "live_total_s": self.live_total_s,
            "predicted_total_s": self.predicted_total_s,
            "rel_err": self.rel_err,
            "n_events": self.n_events,
            "n_handled": self.n_handled,
            "n_migrations": self.n_migrations,
            "n_blacklisted": self.n_blacklisted,
            "n_reprovisioned": self.n_reprovisioned,
            "n_stalls": self.n_stalls,
            "n_replans": self.n_replans,
            "replans": self.replans,
            "n_shards_done": len(self.results),
        }


# -------------------------------------------------------------- daemon ---
class OrchestratorDaemon:
    """Supervises one live campaign described by a :class:`LivePlan`."""

    def __init__(
        self,
        plan: LivePlan,
        spool: Spool,
        launcher,
        *,
        injector="kill",
        profile: str = "placentia",
        clock: Callable[[], float] = time.monotonic,
        async_sleep: Optional[Callable] = None,
        poll_wall_s: float = 0.05,
        stall_timeout_wall_s: Optional[float] = None,
        ready_timeout_wall_s: float = 60.0,
        deadline_wall_s: Optional[float] = None,
        planner: Optional[Callable] = None,
        max_replans: int = 1,
        replan_seeds: int = 50,
        respawn_backoff_s: float = 0.2,
        blacklist_ttl_s: Optional[float] = None,
        trace: bool = True,
        prewarm: bool = True,
    ):
        from repro_torch.orchestrator import registry as injector_registry

        self.plan = plan
        self.spec = plan.spec
        self.spool = spool
        self.launcher = launcher
        self.injector = (
            injector if not isinstance(injector, str) else injector_registry.get(injector)
        )
        self.profile = profile
        self.clock = clock
        self.async_sleep = async_sleep if async_sleep is not None else asyncio.sleep
        self.poll_wall_s = float(poll_wall_s)
        # a paced step is the natural liveness quantum: give a healthy
        # worker several of them (plus a floor for poll jitter) before
        # declaring it stalled
        self.stall_timeout_wall_s = (
            stall_timeout_wall_s
            if stall_timeout_wall_s is not None
            else max(6.0 * plan.step_wall_s, 10.0 * self.poll_wall_s, 1.0)
        )
        self.ready_timeout_wall_s = float(ready_timeout_wall_s)
        self.deadline_wall_s = deadline_wall_s
        self.planner = planner
        self.max_replans = int(max_replans)
        self.replan_seeds = int(replan_seeds)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.blacklist_ttl_s = blacklist_ttl_s
        self.trace_on = bool(trace)
        self.prewarm = bool(prewarm)

        # ------------------------------------------------- mutable state ---
        self.handles: Dict[int, WorkerHandle] = {}  # wid -> handle
        self.wid_of_host: Dict[int, int] = {}  # host -> current wid
        self.shard_of_host: Dict[int, int] = {}
        self.rt: Optional[ClusterRuntime] = None
        self.strat = None
        self.detector = None
        self._seq = 0
        self._dead_wids: set = set()
        self._hb_seen: Dict[int, float] = {}  # wid -> last hb t_wall_s
        self._step_seen: Dict[int, int] = {}  # wid -> last step observed
        self._latency_s: Dict[int, float] = {}  # host -> latest sim-scaled step latency
        self._inj_slot_of_host: Dict[int, int] = {}
        self._predicted_hosts: set = set()
        self._resumes: List[Tuple[float, int, int]] = []  # (due_wall, host, shard)
        self._pending_repairs: Dict[int, float] = {}  # host -> sim completion
        self._respawn_retry: Dict[int, Tuple[float, int]] = {}  # host -> (due_wall, attempt)
        self._blacklist_expiry_s: Dict[int, float] = {}
        self._done_wall: Dict[int, float] = {}  # shard -> completion wall instant
        # wid -> wall instant its boot began (its respawn, else its first
        # "booting" beat), until it beats anything else
        self._booting_since: Dict[int, float] = {}
        self._t0_wall: Optional[float] = None
        #: barrier name -> wid -> wall seconds from the fleet's spawn to it
        self.ready_s: Dict[str, Dict[int, float]] = {}

    # -------------------------------------------------------------- util ---
    def _now_sim_s(self) -> float:
        return (self.clock() - self._t0_wall) * self.plan.time_scale

    def _send(self, wid: int, payload: Dict) -> None:
        self._seq += 1
        self.spool.send_command(wid, payload, self._seq)

    def _assign(self, host: int, shard: int, resume: bool) -> None:
        self._send(
            self.wid_of_host[host],
            {
                "op": "assign",
                "shard": int(shard),
                "n_shards": int(self.spec.n_nodes),
                "n_steps": int(self.plan.n_steps),
                "step_wall_s": float(self.plan.step_wall_s),
                "ckpt_every_steps": int(self.plan.ckpt_every_steps),
                "resume": bool(resume),
            },
        )

    # -------------------------------------------------------------- setup ---
    def _build_cluster(self):
        """Mirror ``CampaignEngine._build``: same runtime, same attach."""
        from repro_torch.strategies import registry as strategy_registry
        from repro_torch.telemetry import resolve as resolve_detector
        from repro_torch.workloads import resolve as resolve_workload

        spec = self.spec
        self.rt = ClusterRuntime(
            n_hosts=spec.n_nodes,
            n_spares=spec.n_spares,
            profile=self.profile,
            graph=DependencyGraph.star(spec.n_nodes - 1)
            if spec.n_nodes > 1
            else DependencyGraph(),
            seed=self.plan.seed,
            racks=spec.effective_racks(),
        )
        self.strat = strategy_registry.get(self.plan.strategy, placement=spec.placement)
        # same billing measure the engine uses for this workload, so the
        # strategy's modelled reinstate/overhead (our scaled stalls) match;
        # it calibrates on the workers' device
        micro = resolve_workload(self.plan.workload, spec, device=self.plan.device).micro(
            self.profile, n_nodes=spec.n_nodes
        )
        payloads = {h: {"shard": h} for h in range(spec.n_nodes)}
        self.strat.attach(self.rt, payloads, micro=micro, period_s=spec.period_s)
        self.shard_of_host = {h: h for h in range(spec.n_nodes)}
        self.detector = resolve_detector(self.plan.detector, self.plan.device)
        self.detector.bind(self.rt)

    def _abort_launch(self, msg: str):
        for handle in self.handles.values():
            handle.reap()
        raise RuntimeError(msg)

    async def _barrier(self, waiting: set, ready: Callable, what: str, t0: float):
        """Poll until ``ready(heartbeat)`` holds for every worker in
        ``waiting``; a worker that exits first, or the ready timeout,
        reaps the fleet and raises. Records each worker's seconds from
        ``t0`` to readiness in ``self.ready_s[what]``."""
        seen = self.ready_s.setdefault(what, {})
        while waiting:
            for wid in sorted(waiting):
                if ready(self.spool.read_heartbeat(wid)):
                    waiting.discard(wid)
                    seen[wid] = self.clock() - t0
                elif self.handles[wid].poll_exit() is not None:
                    self._abort_launch(
                        f"worker {wid} exited with code {self.handles[wid].poll_exit()} "
                        f"before {what}"
                    )
            if not waiting:
                break
            if self.clock() - t0 > self.ready_timeout_wall_s:
                self._abort_launch(
                    f"workers {sorted(waiting)} never reached {what} within "
                    f"{self.ready_timeout_wall_s}s"
                )
            await self.async_sleep(self.poll_wall_s)

    async def _launch_fleet(self):
        """Start every worker (shard holders + warm spares) and barrier on
        first heartbeat, so spawn cost never lands inside the timed run."""
        H = self.spec.n_nodes + self.spec.n_spares
        t0 = self.clock()
        for wid in range(H):
            self.handles[wid] = self.launcher.launch(wid)
            self.wid_of_host[wid] = wid
        await self._barrier(
            set(range(H)), lambda hb: hb is not None, "first heartbeat", t0
        )
        if self.prewarm:
            # every worker (shard holders AND spares) runs a step of the
            # workload (device context, upload, first launches) before the
            # timed run starts, so neither the first step nor a migration
            # pays that latency
            for wid in range(H):
                self._send(
                    wid,
                    {"op": "warm", "n_shards": self.spec.n_nodes,
                     "n_steps": self.plan.n_steps},
                )
            await self._barrier(
                set(range(H)), lambda hb: hb is not None and hb.get("warmed"), "warm", t0
            )

    # ---------------------------------------------------------- failures ---
    def _handle_failure(self, host: int, t_s: float, cause: str, rec, rep) -> bool:
        """The engine's failure-handling block, verbatim semantics.

        Returns False when the campaign is stranded (no target left)."""
        spec, rt, strat = self.spec, self.rt, self.strat
        rep.n_events += 1
        if not rt.healthy(host):
            return True  # coalesced with an earlier event
        ev = FailureEvent(
            t=t_s, node=host, predictable=False, cause=cause, during_checkpoint=False
        )
        if rec is not None:
            rec.emit(t_s, "failure", node=host, cause=cause, predictable=False)
        self.drift.observe_failure()
        self.strikes[host] = self.strikes.get(host, 0) + 1
        permanent = spec.repair_s is None or self.strikes[host] >= spec.max_strikes

        # a shard whose result already landed has nothing left to migrate
        shard = self.shard_of_host.get(host)
        if shard is not None and (
            shard in self._done_wall or self.spool.read_result(shard) is not None
        ):
            rt.release(host)
            self.shard_of_host.pop(host, None)

        if strat.has_work(host):
            target = strat.pick_target(host, require_free=True)
            if target is None:
                rt.fail(host, permanent=True)
                rep.survived = False
                rep.failed_at_s = float(t_s)
                if rec is not None:
                    rec.emit(t_s, "stranded", node=host)
                return False
            shard = self.shard_of_host.pop(host)
            out = strat.on_failure(ev, target)
            rep.n_handled += 1
            if out.migrated:
                rep.n_migrations += 1
            slot = self._inj_slot_of_host.pop(host, None)
            if slot is not None:
                self._fired_target[slot] = int(target)
            # the strategy's modelled reinstate+overhead bill becomes a
            # real (scaled) stall before the shard resumes on its warm
            # spare; lost work needs no modelling — the target re-runs
            # every step since the last checkpoint at the normal pace
            stall_wall_s = (out.reinstate_s + out.overhead_s) / self.plan.time_scale
            self.shard_of_host[target] = shard
            self._resumes.append((self.clock() + stall_wall_s, target, shard))
            if rec is not None:
                rec.emit(
                    t_s, "verdict", node=host, detector=self.detector.name,
                    predicted=host in self._predicted_hosts, saved=False,
                )
                rec.emit(t_s, "migrate", node=host, target=int(target), outcome=out.outcome)

        rt.fail(host, permanent=permanent)
        if permanent:
            rep.n_blacklisted += 1
            if rec is not None:
                rec.emit(t_s, "blacklist", node=host)
            if self.blacklist_ttl_s is not None:
                self._blacklist_expiry_s[host] = t_s + self.blacklist_ttl_s
        elif spec.repair_s is not None:
            # organic failures can outnumber the tape's declared slots —
            # past the last draw, fall back to the spec's nominal repair
            draws = self.tape.repair_draws
            if self._draw_i < len(draws):
                repair_s = float(draws[self._draw_i])
            else:
                repair_s = float(spec.repair_s)
            self._pending_repairs[host] = t_s + repair_s
            self._draw_i += 1
        # make sure the carcass is really gone (die-cmd deaths already are)
        wid = self.wid_of_host.get(host)
        if wid is not None and wid not in self._dead_wids:
            self._dead_wids.add(wid)
            self.handles[wid].reap()
        return True

    def _respawn(self, host: int, now_wall: float, attempt: int, rec, rep, t_s: float):
        """Bring a repaired host back: provision into the spare pool and
        spawn its replacement process with exponential backoff on failure."""
        try:
            wid = max(self.handles) + 1
            self.handles[wid] = self.launcher.launch(wid)
            self.wid_of_host[host] = wid
            self._booting_since[wid] = now_wall
        except OSError:
            backoff_s = self.respawn_backoff_s * (2 ** attempt)
            self._respawn_retry[host] = (now_wall + backoff_s, attempt + 1)
            return
        self._respawn_retry.pop(host, None)
        if self.rt.provision_spare(host):
            self.rt.heartbeats.revive(host)
            rep.n_reprovisioned += 1
            if rec is not None:
                rec.emit(t_s, "provision", node=host)

    # ------------------------------------------------------------- replan ---
    def _replan(self, t_s: float, drift_info: Dict, rec, rep):
        """Consult the oracle again under the observed conditions and hot-
        swap the strategy (runtime, occupancy and shard map carry over)."""
        from repro_torch.strategies import registry as strategy_registry

        observed = self.spec
        if drift_info["cause"] == "failure_rate":
            observed = scale_failure_rate(self.spec, drift_info["ratio"])
        if self.planner is not None:
            new_name = self.planner(observed, self.plan, drift_info)
        else:
            from repro_torch.orchestrator.plan import choose_strategy

            new_name, _ = choose_strategy(
                observed,
                n_seeds=self.replan_seeds,
                seed=self.plan.seed,
                detector=self.plan.detector,
                workload=self.plan.workload,
                device=self.plan.device,
            )
        rep.n_replans += 1
        rep.replans.append(
            {"t_s": float(t_s), "cause": drift_info["cause"],
             "ratio": drift_info["ratio"], "from": self.strat.name, "to": new_name}
        )
        if rec is not None:
            rec.emit(
                t_s, "rebalance", reason="replan", cause=drift_info["cause"],
                strategy=new_name,
            )
        if new_name != self.strat.name:
            new_strat = strategy_registry.get(new_name, placement=self.spec.placement)
            occupied = {
                h: self.rt.hosts[h].shard
                for h in self.shard_of_host
                if self.rt.hosts[h].shard is not None
            }
            new_strat.attach(
                self.rt, occupied, micro=self.strat.micro, period_s=self.spec.period_s
            )
            self.strat = new_strat
        rep.final_strategy = self.strat.name

    # ---------------------------------------------------------------- run ---
    async def run(self) -> LiveReport:
        from repro_torch.scenarios.trajectory import compile_tape
        from repro_torch.telemetry.frame import frame_from_heartbeats

        plan, spec = self.plan, self.spec
        self.tape = compile_tape(spec, plan.seed)
        self._fired_target: Dict[int, int] = {}
        self._draw_i = 0
        self.strikes: Dict[int, int] = {}
        injections = sorted(
            (i for i in self.injector.schedule(self.tape) if i.t_s < spec.horizon_s),
            key=lambda i: i.t_s,
        )
        inj_i = 0
        expected_failures = max(len(injections), 1)
        self.drift = DriftMonitor(
            expected_failures=expected_failures,
            horizon_s=spec.horizon_s,
            step_wall_s=plan.step_wall_s,
        )

        self._build_cluster()
        rec = None
        if self.trace_on:
            from repro_torch.obs.trace import TraceRecorder

            rec = TraceRecorder()
        rep = LiveReport(
            scenario=spec.name,
            strategy=plan.strategy,
            final_strategy=plan.strategy,
            survived=True,
            live_total_s=None,
            predicted_total_s=plan.predicted_total_s,
        )

        await self._launch_fleet()
        for host in range(spec.n_nodes):
            self._assign(host, self.shard_of_host[host], resume=False)
        self._t0_wall = self.clock()

        running = True
        while running:
            now_wall = self.clock()
            t_s = self._now_sim_s()

            # TTL'd blacklist entries rejoin the eligible pool
            for host, exp_s in list(self._blacklist_expiry_s.items()):
                if exp_s <= t_s:
                    del self._blacklist_expiry_s[host]
                    self.rt.blacklist.discard(host)

            # fire due injections (cascade children chase the migrated shard)
            while inj_i < len(injections) and injections[inj_i].t_s <= t_s:
                inj = injections[inj_i]
                inj_i += 1
                parent = int(self.tape.parent[inj.slot])
                if parent >= 0:
                    host = self._fired_target.get(parent)
                    if host is None:
                        continue  # parent never migrated: child never exists
                else:
                    host = int(self.tape.victim[inj.slot])
                if not self.rt.healthy(host):
                    rep.n_events += 1  # lands on a corpse: coalesced
                    continue
                wid = self.wid_of_host[host]
                self._inj_slot_of_host[host] = inj.slot
                if inj.action in ("kill", "stall"):
                    self.handles[wid].deliver(inj.action)
                elif inj.action == "die":
                    self._send(wid, {"op": "die"})
                elif inj.action == "slow":
                    self._send(wid, {"op": "slow", "factor": inj.factor})
                    self._inj_slot_of_host.pop(host, None)  # not a death

            # ingest heartbeats: liveness beats + step telemetry
            for host, wid in self.wid_of_host.items():
                if wid in self._dead_wids:
                    continue
                hb = self.spool.read_heartbeat(wid)
                if hb is None:
                    continue
                if hb["t_wall_s"] != self._hb_seen.get(wid):
                    self._hb_seen[wid] = hb["t_wall_s"]
                    self.rt.heartbeats.beat(host, at_s=hb["t_wall_s"])
                    if hb.get("state") == "booting":
                        self._booting_since.setdefault(wid, hb["t_wall_s"])
                    else:
                        self._booting_since.pop(wid, None)
                lat = hb.get("step_latency_s")
                if lat is not None and hb.get("step") != self._step_seen.get(wid):
                    self._step_seen[wid] = hb.get("step")
                    self._latency_s[host] = float(lat) * plan.time_scale
                    self.drift.observe_step(float(lat))

            # the existing Detector protocol, fed live telemetry
            self.rt.heartbeats.tick()
            n_hosts = self.rt.heartbeats.n
            step_latency_s = np.array(
                [self._latency_s.get(h, 0.0) for h in range(n_hosts)], np.float64
            )
            frame = frame_from_heartbeats(
                self.rt.heartbeats, t_s, step_latency_s=step_latency_s
            )
            for v in self.detector.observe(t_s, frame):
                if v.kind == "failure_predicted":
                    self._predicted_hosts.add(v.node)
                elif v.kind == "straggler" and rec is not None:
                    rec.emit(
                        t_s, "verdict", node=v.node, detector=self.detector.name,
                        predicted=True, saved=False, straggler=True,
                    )

            # liveness: typed exit codes, then heartbeat stalls
            for wid, handle in list(self.handles.items()):
                if wid in self._dead_wids:
                    continue
                code = handle.poll_exit()
                if code is None:
                    continue
                self._dead_wids.add(wid)
                final = self.spool.read_final(wid)
                cause = final["cause"] if final else contract.classify_exit(code)
                host = next(h for h, w in self.wid_of_host.items() if w == wid)
                if not self._handle_failure(host, t_s, cause, rec, rep):
                    running = False
                    break
            if not running:
                break

            for host in self.rt.heartbeats.stalled(
                self.stall_timeout_wall_s, now_s=now_wall
            ):
                wid = self.wid_of_host.get(host)
                if wid is None or wid in self._dead_wids:
                    continue
                if now_wall - self._booting_since.get(wid, -np.inf) <= self.ready_timeout_wall_s:
                    # still booting: respawned and not yet heard, or its
                    # last beat says "booting" (a torch worker beats once
                    # before its torch import and device context, which
                    # outlast a stall timeout; the host's last beat before
                    # that is its dead predecessor's). It gets the fleet's
                    # ready timeout instead. The reference reaps it here
                    continue
                rep.n_stalls += 1
                self._dead_wids.add(wid)
                self.handles[wid].reap()
                if not self._handle_failure(host, t_s, "stalled", rec, rep):
                    running = False
                    break
            if not running:
                break

            # modelled reinstate+overhead stalls elapse -> shard resumes
            for due_wall, target, shard in list(self._resumes):
                if now_wall >= due_wall:
                    self._resumes.remove((due_wall, target, shard))
                    self._assign(target, shard, resume=True)

            # repairs completing before t rejoin the pool, completion order
            for host, tr_s in sorted(
                self._pending_repairs.items(), key=lambda kv: (kv[1], kv[0])
            ):
                if tr_s < t_s:
                    del self._pending_repairs[host]
                    self._respawn(host, now_wall, 0, rec, rep, tr_s)
            for host, (due_wall, attempt) in list(self._respawn_retry.items()):
                if now_wall >= due_wall:
                    self._respawn(host, now_wall, attempt, rec, rep, t_s)

            # drift: the spec is lying -> consult the oracle again
            if rep.n_replans < self.max_replans:
                d = self.drift.drifted(t_s)
                if d is not None:
                    self._replan(t_s, d, rec, rep)

            # completion: every shard's result landed in the spool
            for k in range(spec.n_nodes):
                if k not in self._done_wall and self.spool.read_result(k) is not None:
                    self._done_wall[k] = now_wall
            if len(self._done_wall) == spec.n_nodes:
                rep.live_total_s = (max(self._done_wall.values()) - self._t0_wall) * plan.time_scale
                break

            if self.deadline_wall_s is not None and now_wall - self._t0_wall > self.deadline_wall_s:
                rep.survived = False
                rep.failed_at_s = t_s
                break

            self.spool.write_status(
                {"t_s": t_s, "state": "running", "strategy": self.strat.name,
                 "shards_done": len(self._done_wall), "n_events": rep.n_events,
                 "n_migrations": rep.n_migrations}
            )
            await self.async_sleep(self.poll_wall_s)

        # teardown: stop survivors, reap everything
        for wid, handle in self.handles.items():
            if wid not in self._dead_wids:
                self._send(wid, {"op": "stop"})
        for _ in range(int(2.0 / self.poll_wall_s)):
            if all(
                h.poll_exit() is not None
                for w, h in self.handles.items()
                if w not in self._dead_wids
            ):
                break
            await self.async_sleep(self.poll_wall_s)
        for handle in self.handles.values():
            handle.reap()

        rep.results = self.spool.results(spec.n_nodes)
        if rec is not None:
            from repro_torch.strategies.base import CostContext

            table = self.strat.cost_table(
                CostContext(micro=self.strat.micro, period_h=spec.period_s / 3600.0)
            )
            rep.trace = rec.finalize(
                spec,
                approach=self.strat.name,
                seed=plan.seed,
                detector=self.detector.name,
                workload=plan.workload,
                survived=rep.survived,
                failed_at_s=rep.failed_at_s,
                mode_window=table.mode == "window",
                flags_stragglers=self.detector.flags_stragglers,
                source="live",
            )
        rep.final_strategy = self.strat.name
        self.spool.write_status(
            {"state": "done" if rep.survived else "lost", **rep.to_dict()}
        )
        return rep

    def run_sync(self) -> LiveReport:
        return asyncio.run(self.run())
