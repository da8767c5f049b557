"""The program's span table as the span readers take it
(``dpsvm_tpu_torch/obs/trace.py span_totals``). The program's spans are
live only while a profiler records, and a run records only in its
profiled slice of whole jobs, so in a traced run the table holds exactly
that slice. None where there is no slice, where the program keeps no
table (an earlier commit), or where a span the reader needs is absent,
untimed on the device, or lost device events."""

from __future__ import annotations


def table(run):
    """The span table of a traced training run, or None."""
    if run.get("kind") != "train" or run.get("slice") is None:
        return None
    try:
        from dpsvm_tpu_torch.obs import trace
    except ImportError:
        return None
    read = getattr(trace, "span_totals", None)
    return read() if read is not None else None


def per(run, name: str, field: str, unit_span: str):
    """Milliseconds of span `name`'s `field` ("host_s" or "device_s")
    over the count of span `unit_span` ("train": a job; "block/select":
    a round)."""
    tab = table(run)
    if not tab or name not in tab or unit_span not in tab:
        return None
    ent, n = tab[name], tab[unit_span]["count"]
    if not n or ent[field] is None or ent.get("dropped"):
        return None
    return 1e3 * ent[field] / n


def self_ms(run, name: str, children):
    """Milliseconds a job of span `name`'s host time less its
    `children`'s (a child the table lacks counts 0)."""
    tab = table(run)
    if not tab or name not in tab or not tab[name]["count"]:
        return None
    own = tab[name]["host_s"] - sum(tab[c]["host_s"] for c in children
                                    if c in tab)
    return 1e3 * own / tab[name]["count"]
