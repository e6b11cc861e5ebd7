"""Subprocess-free test doubles for the orchestrator daemon.

The port of ``repro.orchestrator.testing``, unchanged in behaviour: the
same scripted campaign gives the same report and trace in both packages.

The daemon takes its clock and its sleep as injected callables, so the
whole supervision loop — spool protocol, injections, stall detection,
migration, re-planning — runs deterministically in-process:

* :class:`FakeClock` — a manually advanced monotonic clock;
* :class:`StubWorker` — a :class:`~repro_torch.orchestrator.daemon.WorkerHandle`
  that *is* the worker: it speaks the full spool protocol (heartbeats,
  checkpoints, results, sequenced commands, typed exits) but "computes"
  by advancing a step counter against the fake clock;
* :class:`StubLauncher` — hands out stub workers, and can be told to
  fail the next N spawns (exercising the daemon's exponential backoff);
* :func:`scripted_sleeper` — the daemon's ``async_sleep``: advances the
  fake clock, fires scripted mid-run actions (extra kills, rate
  changes), then pumps every stub one scheduling round.

No wall clock, no asyncio event-loop timers, no subprocesses — a full
campaign with failures, migrations and a re-plan runs in milliseconds.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.orchestrator import contract
from repro_torch.orchestrator.daemon import WorkerHandle
from repro_torch.orchestrator.spool import Spool


class FakeClock:
    """A monotonic clock advanced by hand (seconds)."""

    def __init__(self, start_s: float = 0.0):
        self.t_s = float(start_s)

    def __call__(self) -> float:
        return self.t_s

    def advance(self, dt_s: float) -> None:
        self.t_s += float(dt_s)


class StubWorker(WorkerHandle):
    """Handle and worker in one object, driven by :meth:`pump`."""

    def __init__(self, wid: int, spool: Spool, clock: FakeClock):
        self.wid = int(wid)
        self.spool = spool
        self.clock = clock
        self.exit_code: Optional[int] = None
        self.frozen = False  # SIGSTOP analogue: alive but silent
        self.last_seq = -1
        self.shard: Optional[int] = None
        self.n_steps = 0
        self.step = 0
        self.step_wall_s = 0.0
        self.ckpt_every_steps = 2
        self.slow_factor = 1.0
        self.warmed = False
        self.done = False
        self._next_step_at_s: Optional[float] = None

    # ------------------------------------------------------------ handle ---
    def start(self) -> None:
        self.pump()

    def poll_exit(self) -> Optional[int]:
        return self.exit_code

    def deliver(self, action: str) -> None:
        if self.exit_code is not None:
            return
        if action == "kill":
            self.exit_code = -9
        elif action == "stall":
            self.frozen = True

    def reap(self) -> None:
        if self.exit_code is None:
            self.exit_code = -9

    # ------------------------------------------------------------ worker ---
    def _hb(self, state: str, step_latency_s: Optional[float] = None) -> None:
        self.spool.write_heartbeat(
            self.wid,
            {
                "t_wall_s": self.clock(),
                "pid": -1,
                "state": state,
                "shard": self.shard,
                "step": self.step,
                "n_steps": self.n_steps,
                "step_latency_s": step_latency_s,
                "compute_s": 0.0,
                "slow_factor": self.slow_factor,
                "warmed": self.warmed,
            },
        )

    def _ckpt(self) -> None:
        self.spool.write_checkpoint(
            self.shard, {"shard": self.shard, "step": self.step, "state": {"step": self.step}}
        )

    def _exit(self, code: int) -> None:
        self.spool.write_final(
            self.wid,
            {"code": code, "cause": contract.EXIT_NAMES.get(code, "crashed"),
             "shard": self.shard, "step": self.step},
        )
        self.exit_code = code

    def pump(self) -> None:
        """One scheduling round: consume commands, advance paced steps."""
        if self.exit_code is not None or self.frozen:
            return
        cmd = self.spool.read_command(self.wid)
        if cmd is not None and int(cmd.get("seq", -1)) > self.last_seq:
            self.last_seq = int(cmd["seq"])
            op = cmd.get("op")
            if op == "die":
                return self._exit(contract.EXIT_FAULT_INJECTED)
            if op == "stop":
                return self._exit(contract.EXIT_PREEMPTED)
            if op == "slow":
                self.slow_factor = float(cmd.get("factor", 2.0))
            elif op == "warm":
                self.warmed = True
            elif op == "assign":
                self.shard = int(cmd["shard"])
                self.n_steps = int(cmd["n_steps"])
                self.step_wall_s = float(cmd.get("step_wall_s", 0.0))
                self.ckpt_every_steps = int(cmd.get("ckpt_every_steps", 2))
                self.step = 0
                self.done = False
                if cmd.get("resume"):
                    ck = self.spool.read_checkpoint(self.shard)
                    if ck is not None:
                        self.step = int(ck["step"])
                self._next_step_at_s = self.clock() + self.step_wall_s * self.slow_factor
        now_s = self.clock()
        while (
            self.shard is not None
            and self.step < self.n_steps
            and self._next_step_at_s is not None
            and now_s >= self._next_step_at_s
        ):
            self.step += 1
            if self.step % self.ckpt_every_steps == 0 or self.step == self.n_steps:
                self._ckpt()
            self._hb("running", step_latency_s=self.step_wall_s * self.slow_factor)
            self._next_step_at_s += self.step_wall_s * self.slow_factor
        if self.shard is not None and self.step >= self.n_steps and not self.done:
            self.done = True
            self.spool.write_result(
                self.shard, {"shard": self.shard, "steps_done": self.step, "payload": {}}
            )
        self._hb("done" if self.done else ("running" if self.shard is not None else "idle"))


class StubLauncher:
    """Hands out :class:`StubWorker` handles sharing one spool + clock."""

    def __init__(self, spool: Spool, clock: FakeClock):
        self.spool = spool
        self.clock = clock
        self.stubs: Dict[int, StubWorker] = {}
        self.fail_next_spawns = 0  # make launch() raise, testing backoff
        self.n_spawn_attempts = 0

    def launch(self, wid: int) -> StubWorker:
        self.n_spawn_attempts += 1
        if self.fail_next_spawns > 0:
            self.fail_next_spawns -= 1
            raise OSError("injected spawn failure")
        s = StubWorker(wid, self.spool, self.clock)
        self.stubs[wid] = s
        s.start()
        return s


def scripted_sleeper(
    clock: FakeClock,
    launcher: StubLauncher,
    script: Optional[List[Tuple[float, Callable[[], None]]]] = None,
):
    """The daemon's ``async_sleep`` for stub runs: advance the fake
    clock, fire any scripted ``(at_s, action)`` whose time has come, then
    pump every stub worker one round."""
    pending = sorted(script or [], key=lambda x: x[0])

    async def sleep(dt_s: float) -> None:
        clock.advance(dt_s)
        while pending and pending[0][0] <= clock():
            pending.pop(0)[1]()
        for s in list(launcher.stubs.values()):
            s.pump()

    return sleep
