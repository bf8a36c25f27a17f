"""Arithmetic shared by the metric readers (metrics/<name>.py): each
reader takes a run's record and returns a number, or None where the run has
nothing for it to read (another kind of cell, no trace, no such work)."""

from .counts import BF16_TC_FLOPS, least_ms
from .trace import busy_us


def window(record, kind):
    return record["window"] if record["kind"] == kind else None


def rate(record, kind):
    """Images completed in the window over its seconds."""
    w = window(record, kind)
    return None if w is None else w["images"] / w["seconds"]


def host_ms(record, kind):
    """Host milliseconds per step (or frame) spent in the program's calls."""
    w = window(record, kind)
    return None if w is None or not w["steps"] else 1e3 * w["host_s"] / w["steps"]


def mfu(record, kind, count):
    """Frozen operations per image x the window's images per second, as a
    share of the dense bf16 peak, in %."""
    r = rate(record, kind)
    return None if r is None else 100.0 * record["counts"][count] * r / BF16_TC_FLOPS


def _trace(record, kind):
    return record.get("trace") if record["kind"] == kind else None


def component_ms(record, kind, names):
    """Device milliseconds per profiled step of the kernels attributed to
    the named components."""
    tr = _trace(record, kind)
    if tr is None:
        return None
    ms = sum(tr["components"].get(n, 0.0) for n in names) / tr["steps"]
    return ms if ms > 0 else None


def idle_pct(record, kind):
    """1 - device-busy ms per profiled step (union of kernel and copy
    intervals) / wall ms per step of the window, in %."""
    tr, w = _trace(record, kind), window(record, kind)
    if tr is None or not tr["ops"] or not w["steps"]:
        return None
    busy = busy_us(tr["ops"]) / 1e3 / tr["steps"]
    return 100.0 * (1.0 - busy / (1e3 * w["seconds"] / w["steps"]))


def enc_msda_roofline(record, kind, directions):
    """The encoder MSDA range's least time per step over its device time
    per step, in %."""
    ms = component_ms(record, kind, ("encoder MSDA",))
    if ms is None:
        return None
    least = least_ms(record["counts"]["enc_msda_per_img_layer"], directions,
                     record["batch"], record["model"]["enc_layers"])
    return 100.0 * least / ms
