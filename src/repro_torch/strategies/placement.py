"""Placement policies: who receives displaced work.

The seed hard-wired target selection as ``ClusterRuntime.pick_target``
calls inside ``agent.py``, ``virtual_core.py``, ``speculative.py``,
``trainer.py`` and ``engine.py``.  Placement is now a pluggable policy
object injected into strategies (and into the runtime as its default):

``nearest-spare``
    byte-for-byte the seed behaviour — healthy spare first, then a
    healthy adjacent host that is not itself predicted to fail, then any
    healthy free host, finally (unless ``require_free``) any healthy
    host;

``partition-aware``
    the ROADMAP network-partition hook: when the runtime carries a
    partition map (``rt.set_partition``), only hosts in the failing
    host's component are eligible — heartbeats cross the cut but
    migrations cannot — and a component holding a minority of the alive
    hosts refuses placement entirely (quorum semantics).

Policies are registered by name so scenario specs / CLI flags can select
them declaratively.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

_PLACEMENTS: Dict[str, Type["PlacementPolicy"]] = {}


def register_placement(name: str):
    def deco(cls):
        cls.name = name
        _PLACEMENTS[name] = cls
        return cls

    return deco


def get_placement(name: str, **cfg) -> "PlacementPolicy":
    if isinstance(name, PlacementPolicy):
        return name
    try:
        cls = _PLACEMENTS[name]
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r}; have {placement_names()}") from None
    return cls(**cfg)


def placement_names() -> List[str]:
    return sorted(_PLACEMENTS)


class PlacementPolicy:
    """Interface: ``pick(rt, failing, require_free)`` -> host id or None."""

    name = "?"

    def pick(self, rt, failing: int, require_free: bool = False) -> Optional[int]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<placement {self.name}>"


@register_placement("nearest-spare")
class NearestSpare(PlacementPolicy):
    """The seed ``ClusterRuntime.pick_target`` logic, verbatim: prefer a
    healthy spare; else a healthy adjacent host that is not itself
    predicted to fail. Blacklisted hosts are never chosen. With
    ``require_free`` the occupied fallbacks are skipped entirely (the
    scenario engine's no-co-host policy); by default an occupied adjacent
    core remains a legal last resort — the paper migrates onto busy
    neighbours.

    ``allowed`` is the subclass hook further policies filter through
    (e.g. partition membership)."""

    def allowed(self, rt, failing: int, hid: int) -> bool:
        return True

    def pick(self, rt, failing: int, require_free: bool = False) -> Optional[int]:
        def ok(hid: int) -> bool:
            return (
                hid not in rt.blacklist
                and rt.healthy(hid)
                and self.allowed(rt, failing, hid)
            )

        def free(hid: int) -> bool:
            return rt.hosts[hid].shard is None

        for s in rt.spares:
            if ok(s) and free(s):
                return s
        preds = rt.neighbour_predictions(failing)
        for nb, doomed in preds.items():
            if not doomed and ok(nb) and (free(nb) or not require_free):
                return nb
        for hid in rt.hosts:
            if hid != failing and ok(hid) and free(hid):
                return hid
        if not require_free:
            for hid in rt.hosts:
                if hid != failing and ok(hid):
                    return hid
        return None


@register_placement("partition-aware")
class PartitionAware(NearestSpare):
    """Same preference order, restricted to the failing host's partition
    component, with quorum: a minority component cannot accept placements
    (its view of the cluster may be stale; re-placing work there would
    double-run the sub-job once the cut heals). Without a partition map
    this degrades to exact nearest-spare behaviour."""

    def __init__(self, require_quorum: bool = True):
        self.require_quorum = require_quorum

    def pick(self, rt, failing: int, require_free: bool = False) -> Optional[int]:
        part = getattr(rt, "partition", None)
        if part is not None and self.require_quorum:
            alive = [h for h in rt.hosts if rt.healthy(h)]
            component = part.get(failing)
            members = [h for h in alive if part.get(h) == component]
            if 2 * len(members) <= len(alive):
                return None  # minority side: no quorum, no placement
        return super().pick(rt, failing, require_free=require_free)

    def allowed(self, rt, failing: int, hid: int) -> bool:
        part = getattr(rt, "partition", None)
        return part is None or part.get(hid) == part.get(failing)
