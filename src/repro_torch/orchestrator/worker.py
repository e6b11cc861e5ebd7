"""The supervised worker: runs one shard of real work under the daemon.

The port of ``repro.orchestrator.worker``. This is the compute-side half
of the shepherd pair (SNIPPETS.md snippet 1): a thin wrapper that
executes a registered workload's *real* step function, drops a heartbeat
+ step-latency sample into the spool after every step, checkpoints its
migratable state, and dies with the typed exit contract
(:mod:`repro_torch.orchestrator.contract`).

Pacing makes live and simulated timelines commensurable. The daemon
plans in *scaled time*: each step represents ``step_sim_s`` simulated
seconds and is paced to ``step_wall_s`` wall seconds (sleeping off any
surplus), so a shard's wall duration maps linearly onto the simulator's
horizon and a mid-run kill loses real, re-doable work. A ``slow``
command multiplies the pace (the straggler failure mode); probe
overhead the strategy would bill is folded into ``step_wall_s`` by the
planner, not re-modelled here.

Step programs bind workload names to runnable shards:

``analytic``       numpy matmul loop (light spawn; imports no torch)
``genome_search``  one search sub-job of :class:`~repro_torch.data.genome.GenomeSearchJob`
                   on the worker's device (the paper's validation job)
``train_llm``      toy torch MLP train step (autograd gradient descent)

A program's ``step`` returns with its device work done (the device is
synchronized), so the compute time the worker reads is the card's work
and not the enqueue. Checkpoints are JSON in the reference's layout: a
shard checkpointed by either package resumes in the other.

torch imports are lazy so analytic workers spawn in milliseconds.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.orchestrator import contract
from repro_torch.orchestrator.spool import Spool

#: default checkpoint cadence (steps) when an assignment doesn't set one
DEFAULT_CKPT_EVERY_STEPS = 2


# ----------------------------------------------------------- step programs ---
class StepProgram:
    """One runnable shard: a real step function plus serialisable state.
    ``device`` is where its work runs (None: the host, no torch)."""

    device = None

    def step(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def state_dict(self) -> Dict:  # pragma: no cover - interface
        raise NotImplementedError

    def load_state(self, state: Dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def result(self) -> Dict:
        return {}


class AnalyticProgram(StepProgram):
    """Numpy matmul accumulation — cheap, deterministic, no torch import."""

    def __init__(self, seed: int, shard: int, size: int = 96):
        rng = np.random.default_rng(seed * 1000 + shard)
        self.a = rng.standard_normal((size, size))
        self.acc = np.zeros((size, size))
        self.steps_done = 0

    def step(self) -> None:
        self.acc = self.acc + self.a @ self.a.T
        self.steps_done += 1

    def state_dict(self) -> Dict:
        return {"steps_done": self.steps_done, "trace_sum": float(np.trace(self.acc))}

    def load_state(self, state: Dict) -> None:
        self.steps_done = int(state["steps_done"])
        self.acc = self.steps_done * (self.a @ self.a.T)  # state is replayable

    def result(self) -> Dict:
        return {"trace_sum": float(np.trace(self.acc)), "steps_done": self.steps_done}


class GenomeProgram(StepProgram):
    """One search sub-job of the paper's genome job; a step is one chunk,
    searched on ``device``."""

    def __init__(self, seed: int, n_shards: int, n_steps: int, shard: int, device="cuda"):
        from repro_torch.data.genome import GenomeSearchJob, make_genome
        from repro_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        # every worker rebuilds the same job deterministically from the seed,
        # so a migrated shard resumes on identical data
        total_chunks = n_shards * n_steps
        genome, patterns, _ = make_genome(
            length=2048 * total_chunks, n_patterns=6, seed=seed
        )
        self.job = GenomeSearchJob(
            genome, patterns, n_search=n_shards, chunks_per_node=n_steps,
            device=str(self.device),
        )
        self.state = {"node": shard, "cursor": 0, "hits": []}

    def step(self) -> None:
        from repro_torch.utils.device import synchronize

        self.job.run_sub_job_step(self.state)
        synchronize(self.device)

    def state_dict(self) -> Dict:
        return {
            "node": self.state["node"],
            "cursor": self.state["cursor"],
            "hits": [list(h) for h in self.state["hits"]],
        }

    def load_state(self, state: Dict) -> None:
        self.state = {
            "node": int(state["node"]),
            "cursor": int(state["cursor"]),
            "hits": [tuple(h) for h in state["hits"]],
        }

    def result(self) -> Dict:
        return {"hits": [list(h) for h in sorted(set(map(tuple, self.state["hits"])))]}


class TrainProgram(StepProgram):
    """Toy MLP train step: float32 gradient descent on a fixed batch, on
    ``device``. The weights and the batch are drawn as the reference draws
    them, so both packages start from the same float32 values."""

    def __init__(self, seed: int, shard: int, width: int = 32, device="cuda"):
        import torch

        from repro_torch.utils.device import resolve_device

        self._torch = torch
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed * 1000 + shard)
        self.w1 = self._tensor(rng.standard_normal((width, width)) * 0.1)
        self.w2 = self._tensor(rng.standard_normal((width, 1)) * 0.1)
        self.x = self._tensor(rng.standard_normal((64, width)))
        self.y = self._tensor(rng.standard_normal((64, 1)))
        self.steps_done = 0

    def _tensor(self, a):
        return self._torch.tensor(np.asarray(a), dtype=self._torch.float32, device=self.device)

    def _loss(self, w1, w2):
        h = self._torch.tanh(self.x @ w1)
        return self._torch.mean((h @ w2 - self.y) ** 2)

    def step(self) -> None:
        from repro_torch.utils.device import synchronize

        w1 = self.w1.detach().requires_grad_()
        w2 = self.w2.detach().requires_grad_()
        g1, g2 = self._torch.autograd.grad(self._loss(w1, w2), (w1, w2))
        self.w1 = w1.detach() - 0.05 * g1
        self.w2 = w2.detach() - 0.05 * g2
        self.steps_done += 1
        synchronize(self.device)

    def state_dict(self) -> Dict:
        return {
            "steps_done": self.steps_done,
            "w1": self.w1.cpu().numpy().tolist(),
            "w2": self.w2.cpu().numpy().tolist(),
        }

    def load_state(self, state: Dict) -> None:
        self.steps_done = int(state["steps_done"])
        self.w1 = self._tensor(state["w1"])
        self.w2 = self._tensor(state["w2"])

    def result(self) -> Dict:
        return {"loss": float(self._loss(self.w1, self.w2)), "steps_done": self.steps_done}


def make_program(
    workload: str, seed: int, n_shards: int, n_steps: int, shard: int, device="cuda"
) -> StepProgram:
    """Bind a workload name to a runnable shard program on ``device``
    (``analytic`` runs numpy on the host whatever the device)."""
    if workload == "analytic":
        return AnalyticProgram(seed, shard)
    if workload == "genome_search":
        return GenomeProgram(seed, n_shards, n_steps, shard, device=device)
    if workload in ("train_llm", "train"):
        return TrainProgram(seed, shard, device=device)
    raise KeyError(
        f"no step program bound for workload {workload!r}; "
        "have ['analytic', 'genome_search', 'train_llm']"
    )


# -------------------------------------------------------------- worker loop ---
class Worker:
    """The supervised loop: poll commands, run paced steps, heartbeat."""

    def __init__(
        self,
        spool: Spool,
        wid: int,
        workload: str,
        seed: int,
        *,
        device: str = "cuda",
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        idle_poll_wall_s: float = 0.02,
        abort_after_s: Optional[float] = None,
    ):
        self.spool = spool
        self.wid = int(wid)
        self.workload = workload
        self.seed = int(seed)
        self.device = device
        self.clock = clock
        self.sleep = sleep
        self.idle_poll_wall_s = idle_poll_wall_s
        self.abort_after_s = abort_after_s  # self-watchdog: exceed it -> EXIT_STALLED
        self.last_seq = -1
        self.program: Optional[StepProgram] = None
        self.shard: Optional[int] = None
        self.step = 0
        self.n_steps = 0
        self.step_wall_s = 0.0
        self.ckpt_every_steps = DEFAULT_CKPT_EVERY_STEPS
        self.slow_factor = 1.0
        self.done = False
        self.warmed = False

    def _program(self, n_shards: int, n_steps: int, shard: int) -> StepProgram:
        return make_program(self.workload, self.seed, n_shards, n_steps, shard, self.device)

    # ------------------------------------------------------------ spool IO ---
    def _heartbeat(
        self,
        state: str,
        step_latency_s: Optional[float] = None,
        compute_s: Optional[float] = None,
    ) -> None:
        dev = None if self.program is None else self.program.device
        self.spool.write_heartbeat(
            self.wid,
            {
                "t_wall_s": self.clock(),
                "pid": os.getpid(),
                "state": state,
                "shard": self.shard,
                "step": self.step,
                "n_steps": self.n_steps,
                "step_latency_s": step_latency_s,
                "compute_s": compute_s,
                "slow_factor": self.slow_factor,
                "warmed": self.warmed,
                "device": None if dev is None else str(dev),
            },
        )

    def _checkpoint(self) -> None:
        if self.program is None or self.shard is None:
            return
        self.spool.write_checkpoint(
            self.shard,
            {"shard": self.shard, "step": self.step, "state": self.program.state_dict()},
        )

    def _exit(self, code: int) -> int:
        self.spool.write_final(
            self.wid,
            {"code": code, "cause": contract.EXIT_NAMES.get(code, "crashed"),
             "shard": self.shard, "step": self.step},
        )
        return code

    # ------------------------------------------------------------ commands ---
    def _apply_command(self, cmd: Dict) -> Optional[int]:
        """Returns an exit code when the command terminates the worker."""
        op = cmd.get("op")
        if op == "die":
            return self._exit(contract.EXIT_FAULT_INJECTED)
        if op == "stop":
            self._checkpoint()
            return self._exit(contract.EXIT_PREEMPTED)
        if op == "slow":
            self.slow_factor = float(cmd.get("factor", 2.0))
        elif op == "checkpoint":
            self._checkpoint()
        elif op == "warm":
            # run one step of a throwaway program (the device's context,
            # the job's upload, the first launches) so a later migration
            # resumes at full pace (warm-spare contract)
            prog = self._program(int(cmd.get("n_shards", 1)), int(cmd.get("n_steps", 1)), 0)
            prog.step()
            self.warmed = True
        elif op == "assign":
            self.shard = int(cmd["shard"])
            self.n_steps = int(cmd["n_steps"])
            self.step_wall_s = float(cmd.get("step_wall_s", 0.0))
            self.ckpt_every_steps = int(cmd.get("ckpt_every_steps", DEFAULT_CKPT_EVERY_STEPS))
            self.program = self._program(int(cmd.get("n_shards", 1)), self.n_steps, self.shard)
            self.step = 0
            self.done = False
            if cmd.get("resume"):
                ck = self.spool.read_checkpoint(self.shard)
                if ck is not None:
                    self.program.load_state(ck["state"])
                    self.step = int(ck["step"])
        return None

    # ---------------------------------------------------------------- loop ---
    def run(self) -> int:
        started_s = self.clock()
        self._heartbeat("idle")
        while True:
            if self.abort_after_s is not None and self.clock() - started_s > self.abort_after_s:
                return self._exit(contract.EXIT_STALLED)
            cmd = self.spool.read_command(self.wid)
            if cmd is not None and int(cmd.get("seq", -1)) > self.last_seq:
                self.last_seq = int(cmd["seq"])
                code = self._apply_command(cmd)
                if code is not None:
                    return code
            if self.program is not None and self.step < self.n_steps:
                t0 = self.clock()
                self.program.step()  # returns with the device's work done
                compute_s = self.clock() - t0
                self.step += 1
                if self.step % self.ckpt_every_steps == 0 or self.step == self.n_steps:
                    self._checkpoint()
                # telemetry reports the *effective* step duration (compute
                # padded to the pace) so a slowed worker reads as a
                # straggler to the daemon's EWMA detector, while compute_s
                # keeps the raw step time for calibration
                pace_wall_s = self.step_wall_s * self.slow_factor
                step_latency_s = max(compute_s, pace_wall_s)
                self._heartbeat(
                    "running", step_latency_s=step_latency_s, compute_s=compute_s
                )
                if compute_s < pace_wall_s:
                    self.sleep(pace_wall_s - compute_s)
            elif self.program is not None and not self.done:
                self.done = True
                self.spool.write_result(
                    self.shard,
                    {"shard": self.shard, "steps_done": self.step,
                     "payload": self.program.result()},
                )
                self._heartbeat("done")
            else:
                self._heartbeat("done" if self.done else "idle")
                self.sleep(self.idle_poll_wall_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.orchestrator.worker",
        description="supervised worker process (launched by the daemon)",
    )
    p.add_argument("--spool", required=True, help="spool directory shared with the daemon")
    p.add_argument("--worker-id", type=int, required=True)
    p.add_argument("--workload", default="analytic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the step program runs (analytic runs numpy on the host)")
    p.add_argument(
        "--abort-after-s", type=float, default=None,
        help="self-watchdog: exit with the stalled code after this many wall seconds",
    )
    a = p.parse_args(argv)
    w = Worker(
        Spool(a.spool), a.worker_id, a.workload, a.seed, device=a.device,
        abort_after_s=a.abort_after_s,
    )
    if a.workload != "analytic":
        # heard at once, then torch's import and the device (which fails
        # here, before the first command, where there is no such device);
        # the daemon does not reap a "booting" worker as stalled until its
        # ready timeout
        w._heartbeat("booting")
        from repro_torch.utils.device import resolve_device

        resolve_device(a.device)
    return w.run()


if __name__ == "__main__":
    sys.exit(main())
