"""Straggler detection + failure injection for fault-tolerance tests
(reference: ``repro/runtime/monitor.py``, on the port's ``Tracer``).

StragglerMonitor keeps an EWMA of step latency and flags steps that
exceed ``threshold`` x the moving estimate — on a real fleet this signal
feeds the controller that hot-swaps the slow host (and, within a step,
XLA's collective timeouts do the intra-step mitigation).  The monitor also
exports the history the perf log reads.

Step timing rides on the serving tracer's span primitive
(:class:`repro_torch.serving.trace.Tracer`) instead of ad-hoc ``perf_counter``
bracketing: every step is a ``"step"`` span on the ``"train"`` track and
every straggler verdict an instant event, so ``monitor.tracer.write(path)``
drops a Chrome Trace Event JSON of the training loop for free — the same
timeline format the serving tick pipeline emits.  Pass your own tracer to
merge the training track into a larger trace; by default the monitor owns
a private enabled one.

FailureInjector deterministically raises at chosen steps to exercise the
restart path in tests and examples (chaos-monkey style).
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.serving.trace import Span, Tracer


class StragglerMonitor:
    def __init__(self, alpha: float = 0.2, threshold: float = 2.0,
                 warmup: int = 3, tracer: Optional[Tracer] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.history: List[float] = []
        self.flagged: List[int] = []
        self.tracer = tracer if tracer is not None else Tracer()
        self._span: Optional[Span] = None

    def step_start(self) -> None:
        self._span = self.tracer.span("step", track="train",
                                      step=len(self.history))
        self._span.__enter__()

    def step_end(self) -> bool:
        """Record one step; returns True if the step was a straggler."""
        if self._span is None:
            raise RuntimeError("step_end() without step_start()")
        span, self._span = self._span, None
        span.__exit__(None, None, None)
        dt = span.dur_s
        self.history.append(dt)
        is_straggler = False
        if self.ewma is None:
            self.ewma = dt
        else:
            if (len(self.history) > self.warmup
                    and dt > self.threshold * self.ewma):
                is_straggler = True
                self.flagged.append(len(self.history) - 1)
                self.tracer.instant("straggler", track="train",
                                    step=len(self.history) - 1,
                                    dt_ms=dt * 1e3,
                                    ewma_ms=self.ewma * 1e3)
            # EWMA ignores flagged outliers so one straggler doesn't mask
            # the next
            if not is_straggler:
                self.ewma = self.alpha * dt + (1 - self.alpha) * self.ewma
        return is_straggler


class FailureInjector:
    """Raises RuntimeError at the given steps — once each."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")
