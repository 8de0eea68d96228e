"""Timestamps for the serving stack (reference: ``repro/serving/trace.py``).

Only the canonical monotonic clock ``now`` is ported; the Chrome-trace
``Tracer`` arrives with the scheduler slice.
"""

from __future__ import annotations

import time

#: The canonical monotonic timestamp source (seconds) for the serving stack.
now = time.perf_counter
