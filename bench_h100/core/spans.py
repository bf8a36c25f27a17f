"""Arithmetic shared by the readers of the program's own spans
(metrics/host_*_ms.*.py).  The program (monodetr_torch/utils/trace.py)
keeps a ring of its closed root spans in memory; the readers run in the
same process after loops.run and read it there.  A reader takes the run's
record and that ring (a test passes a ring of its own).

The window's entries are picked by count, in the fixed order in which
core/loops.py calls the program: of the roots of one name, the last
window.steps + trace.steps, less the last trace.steps (the profiled
stretch; 0 without a trace).  The set-up's calls, checked and warm-up,
come before them and are never counted.  Where the ring no longer holds
the window's first entry, or the program keeps no ring (a program without
these spans), a reader returns None."""


def program_ring():
    """The program's ring of closed root spans, oldest first, or None."""
    try:
        from monodetr_torch.utils import trace
    except ImportError:
        return None
    return trace.roots()


def window_roots(record, kind, name, ring=None):
    """The window's roots named `name`, oldest first, or None."""
    w = record["window"] if record["kind"] == kind else None
    if w is None or not w["steps"]:
        return None
    ring = program_ring() if ring is None else ring
    if ring is None:
        return None
    profiled = record["trace"]["steps"] if "trace" in record else 0
    mine = [r for r in ring if r.name == name]
    want = w["steps"] + profiled
    if len(mine) < want:
        return None
    return mine[len(mine) - want:len(mine) - profiled]


def root_ms(record, kind, name, ring=None):
    """Mean host ms of the window's roots named `name`."""
    roots = window_roots(record, kind, name, ring)
    if roots is None:
        return None
    return sum(r.end_ns - r.start_ns for r in roots) / len(roots) / 1e6


def child_ms(record, kind, root, name, ring=None):
    """Mean host ms a window root named `root` spent in its descendants
    named `name`, inclusive of theirs; None where no such root has one."""
    roots = window_roots(record, kind, root, ring)
    if roots is None or not any(name in r.spans for r in roots):
        return None
    return sum(r.spans.get(name, 0) for r in roots) / len(roots) / 1e6
