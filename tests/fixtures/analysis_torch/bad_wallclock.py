"""Fixture: a simulated-side module owning the wall clock: an asyncio
import plus a ``time.monotonic()`` call outside
``repro_torch/orchestrator/``. Campaign time must be a threaded value or
an injected clock; both statements here are ``no-wallclock-in-sim``
violations."""
import asyncio
import time


def elapsed_s(start_s: float) -> float:
    now_s = time.monotonic()  # no-wallclock-in-sim violation
    return now_s - start_s


async def tick_forever(period_s: float):
    while True:
        await asyncio.sleep(period_s)
