"""Statistics counters, the timer and the end-of-run report (port of
sdmm_tpu/utils/stats.py).

Counters are host-side accumulators fed by summaries pulled off the device
at iteration boundaries. Every counter registers itself by name in
``StatsCounter._registry``; the module registers the SDMM set the trainer
feeds, and at process exit the non-zero report goes to the real stderr
under "sdmm_tpu statistics:", one ``name value`` line a counter, as the
reference prints it. A trainer also keeps counters of its own
(``trainer_counters``), which it feeds beside the global ones.
"""

from __future__ import annotations

import atexit
import logging
import sys
import time

log = logging.getLogger("sdmm_tpu")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class StatsCounter:
    """Named counter; kind: 'count' | 'average' | 'percentage'.
    ``register=False`` keeps it out of the global report."""

    _registry: dict[str, "StatsCounter"] = {}

    def __init__(self, name: str, kind: str = "count",
                 register: bool = True):
        self.name = name
        self.kind = kind
        self.value = 0.0
        self.base = 0.0
        if register:
            StatsCounter._registry[name] = self

    def add(self, v: float, base: float = 0.0):
        self.value += float(v)
        self.base += float(base)

    def __iadd__(self, v):
        self.add(v)
        return self

    def result(self) -> float:
        if self.kind == "count":
            return self.value
        r = self.value / max(self.base, 1e-12)
        return r * 100.0 if self.kind == "percentage" else r

    @classmethod
    def report(cls) -> dict:
        return {n: c.result() for n, c in sorted(cls._registry.items())}

    @classmethod
    def print_report(cls):
        rep = cls.report()
        if not rep:
            return
        log.info("statistics:")
        for n, v in rep.items():
            log.info("  %-40s %.4g", n, v)


# The SDMM set (the reference's sdmm_proc.cpp:40-45 counters).
avg_path_length = StatsCounter("integrator.avg_path_length", "average")
avg_invalid_samples = StatsCounter("integrator.pct_invalid_samples",
                                   "percentage")
avg_found_conditional = StatsCounter("guiding.pct_valid_conditionals",
                                     "percentage")


def trainer_counters() -> dict[str, StatsCounter]:
    """A trainer's own counters of the SDMM set it feeds (not registered:
    the global ones above carry the report)."""
    return {
        "avg_path_length": StatsCounter("integrator.avg_path_length",
                                        "average", register=False),
        "avg_found_conditional": StatsCounter(
            "guiding.pct_valid_conditionals", "percentage", register=False),
    }


GLOBAL = {"avg_path_length": avg_path_length,
          "avg_found_conditional": avg_found_conditional}


class Timer:
    """Wall seconds since construction or the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()

    def seconds(self) -> float:
        return time.perf_counter() - self.t0


def report_text() -> str:
    """The at-exit report: "" when every counter is 0."""
    rep = StatsCounter.report()
    if not any(v != 0 for v in rep.values()):
        return ""
    return "sdmm_tpu statistics:\n" + "".join(
        f"  {n:<40} {v:.4g}\n" for n, v in rep.items())


_printed = False


def take_report() -> str:
    """``report_text`` for a caller that prints the report itself: the
    process then prints nothing more at exit."""
    global _printed
    _printed = True
    return report_text()


def _at_exit():
    # The real stderr: logging handlers (and pytest's capture) may be torn
    # down at interpreter exit.
    global _printed
    try:
        if not _printed:
            text = report_text()
            err = getattr(sys, "__stderr__", None)
            if text and err is not None and not err.closed:
                err.write(text)
            _printed = True
    except Exception:
        pass


atexit.register(_at_exit)
