"""The worker exit-code contract (copy of ``repro/orchestrator/contract.py``).

=====================  ====  =================================================
``EXIT_OK``               0  finished its assigned work (or clean idle exit)
``EXIT_FAULT_INJECTED``  42  told to die by the fault injector (``die`` cmd)
``EXIT_STALLED``         43  the process detected its own stall and aborted
``EXIT_PREEMPTED``       44  daemon-initiated shutdown (``stop`` cmd)
=====================  ====  =================================================

Negative return codes are POSIX signal deaths; :func:`classify_exit` maps
them onto fault/stall causes.
"""
from __future__ import annotations

EXIT_OK = 0
EXIT_FAULT_INJECTED = 42
EXIT_STALLED = 43
EXIT_PREEMPTED = 44

EXIT_NAMES = {
    EXIT_OK: "ok",
    EXIT_FAULT_INJECTED: "fault-injected",
    EXIT_STALLED: "stalled",
    EXIT_PREEMPTED: "preempted",
}


def classify_exit(code: int) -> str:
    """Map a raw process return code onto the typed contract.

    Unknown positive codes are crashes; negative codes are signal deaths
    (SIGKILL = injected kill, SIGSTOP/SIGSTKFLT reaps = stall)."""
    if code in EXIT_NAMES:
        return EXIT_NAMES[code]
    if code < 0:  # -signum, as subprocess reports signal deaths
        return "fault-injected" if code == -9 else "stalled"
    return "crashed"
