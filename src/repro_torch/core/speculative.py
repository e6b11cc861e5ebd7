"""Beyond-paper: speculative state egress (pre-staging).

The paper migrates when the predictor crosses its decision threshold.
We add a *warning* threshold below it: when the hazard score enters the
warning band, the payload is pre-staged on the chosen target host in the
background; if the migrate threshold is later crossed, the move is a
pointer flip plus a delta of the leaves that changed since staging
(content-hash diff) — cutting the staging component of reinstate to the
delta size. False warnings cost only background bandwidth, never a move
(Fig 15(c) instability does not apply: the job never relocates on a
warning).

The port of ``repro.core.speculative``: a state's leaves come from
``repro_torch.utils.tree.flatten`` (tensors pickle with their device, so a
payload restores where it was staged from).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


from repro_torch.core.migration import deserialize_state, serialize_state
from repro_torch.core.runtime import ClusterRuntime
from repro_torch.utils.tree import flatten, tree_hash, unflatten


@dataclass
class StagedCopy:
    target: int
    leaf_blobs: Dict[str, bytes]
    leaf_hashes: Dict[str, str]
    staged_at: float


class SpeculativeEgress:
    """Per-supervised-host pre-staging manager."""

    def __init__(self, rt: ClusterRuntime, warn_threshold: float = 0.5, placement=None):
        self.rt = rt
        self.warn_threshold = warn_threshold
        self.placement = placement or rt.placement  # pluggable target choice
        self.staged: Optional[StagedCopy] = None
        self.stats = {"stages": 0, "delta_leaves": 0, "full_leaves": 0}

    def _leaves(self, state):
        flat, _ = flatten(state)
        return {f"leaf_{i:05d}": x for i, x in enumerate(flat)}

    def maybe_stage(self, host: int, state, hazard: float) -> Optional[Dict]:
        """Call per probe tick. Stages (or refreshes the delta of) the
        payload when hazard is in the warning band."""
        if hazard < self.warn_threshold:
            return None
        target = self.placement.pick(self.rt, host)
        if target is None:
            return None
        t0 = time.perf_counter()
        leaves = self._leaves(state)
        sent = 0
        if self.staged is None or self.staged.target != target:
            blobs = {k: serialize_state(v) for k, v in leaves.items()}
            hashes = {k: tree_hash(v) for k, v in leaves.items()}
            self.staged = StagedCopy(target, blobs, hashes, time.perf_counter())
            sent = sum(len(b) for b in blobs.values())
            self.stats["stages"] += 1
            self.stats["full_leaves"] += len(blobs)
        else:
            # delta refresh: only leaves whose content changed
            for k, v in leaves.items():
                h = tree_hash(v)
                if self.staged.leaf_hashes.get(k) != h:
                    self.staged.leaf_blobs[k] = serialize_state(v)
                    self.staged.leaf_hashes[k] = h
                    sent += len(self.staged.leaf_blobs[k])
                    self.stats["delta_leaves"] += 1
        # background wire time — does NOT block the job
        bg_s = sent / self.rt.profile.node_bw
        return {
            "target": target,
            "bytes_sent": sent,
            "background_s": time.perf_counter() - t0 + bg_s,
        }

    def migrate_prestaged(self, host: int, state, treedef_like) -> Dict:
        """Pointer-flip migration: reconstruct from the staged blobs plus a
        final delta of leaves changed since the last refresh."""
        assert self.staged is not None, "nothing staged"
        t0 = time.perf_counter()
        leaves = self._leaves(state)
        delta = 0
        for k, v in leaves.items():
            h = tree_hash(v)
            if self.staged.leaf_hashes.get(k) != h:
                self.staged.leaf_blobs[k] = serialize_state(v)
                self.staged.leaf_hashes[k] = h
                delta += len(self.staged.leaf_blobs[k])
        restored = [
            deserialize_state(self.staged.leaf_blobs[k])
            for k in sorted(self.staged.leaf_blobs)
        ]
        _, treedef = flatten(treedef_like)
        new_state = unflatten(treedef, restored)
        ok = tree_hash(new_state) == tree_hash(state)
        target = self.staged.target
        self.rt.release(host)
        self.rt.occupy(target, new_state, "speculative")
        measured = time.perf_counter() - t0
        speed = max(self.rt.profile.node_speed, 0.1)
        modelled = (
            delta / self.rt.profile.node_bw  # only the delta crosses now
            + 2 * self.rt.profile.msg_latency_s  # pointer flip
            + 0.02 / speed  # activation of the pre-spawned process
        )
        rep = {
            "kind": "speculative",
            "from": host,
            "to": target,
            "delta_bytes": delta,
            "reinstate_measured_s": measured,
            "reinstate_modelled_s": modelled,
            "reinstate_s": measured + modelled,
            "hash_ok": ok,
        }
        self.staged = None
        self.rt.events.append(rep)
        return rep
