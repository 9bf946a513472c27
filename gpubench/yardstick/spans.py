"""The program's span log (``idgrec_torch.engine.profiling.span_log``)
as the per-layer metrics of source ``program_span`` read it: a span's
device ms per enclosing unit (a training step, an evaluation sweep) or
per span. Only spans the profiler recorded whole count: the one in
which the traced window closed is left out, with the unit it ends.

Each reader's ``read(rec, log=None)``, and each function here, reads
the log it is given, else the program's. A program that keeps no log,
or a log without the reader's spans, gives None."""

from __future__ import annotations


def program_log() -> list | None:
    """The program's ended spans, or None where it keeps no log."""
    from idgrec_torch.engine import profiling

    read = getattr(profiling, "span_log", None)
    return None if read is None else read()


def _log(log) -> list:
    return (program_log() if log is None else log) or []


def whole_ms(log, name: str) -> list[float]:
    """Device ms of each whole ``name`` span."""
    return [s.device_ms for s in _log(log) if s.name == name and s.whole]


def per_unit(log, name: str, unit: str) -> float | None:
    """ms of the ``name`` spans directly inside whole ``unit`` spans,
    over the count of those units."""
    log = _log(log)
    units = {k for k, s in enumerate(log) if s.name == unit and s.whole}
    ms = [s.device_ms for s in log if s.name == name and s.parent in units]
    return sum(ms) / len(units) if units and ms else None


def per_span(log, name: str) -> float | None:
    """Mean ms of the whole ``name`` spans."""
    ms = whole_ms(log, name)
    return sum(ms) / len(ms) if ms else None
