"""Per-entrypoint fact extraction: run, record, collect (counterpart of
dpsvm_tpu/analysis/extract.py).

A manifest entry is a list of Units, one per logical step of the host
loop: one round, one tile fold, one bucket dispatch, or the observation
pull that follows a chunk. ``dispatches`` (= the number of units) is a
pinned fact, as in the JAX package: a chunk runner plus its packed
observation read is 2.

The JAX package's facts are static counts of a compiled program, where
a loop body is counted once; the port's are recorded while the unit
runs, so a unit is ONE step (a chunk runner at one round, a stream at
one tile), never a chunk of several rounds whose count would scale
every fact.

A unit that raises becomes a fact (``run_error``: the exception's type
name), as the JAX package's ``trace_error``, so a broken entrypoint
shows up as a budget drift naming it instead of crashing the linter.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

from dpsvm_tpu_torch.analysis import op_facts


@dataclasses.dataclass
class Unit:
    """One step of an entrypoint.

    run   -- () -> result: the step, on inputs the builder already made
             (their making is not recorded);
    state -- optional () -> tensors: the step's carried arguments, for
             the ``inplace`` family (written in place, or allocated
             anew);
    args  -- optional () -> the step's arguments, for the ``memory``
             family's argument and alias bytes.
    """

    name: str
    run: Callable
    state: Optional[Callable] = None
    args: Optional[Callable] = None


def unit_facts(unit: Unit, around: Optional[Callable] = None) -> dict:
    """All fact families for one unit. Never raises for a unit that
    fails: that is the ``run_error`` fact. `around(unit)`, when given,
    is a context manager entered just outside the recording (the card
    phase reads the wrappers' launch counters and the synchronizing
    calls of the unit there)."""
    state = unit.state() if unit.state is not None else ()
    args = unit.args() if unit.args is not None else ()
    rec = op_facts.Recorder(state=state)
    with (around(unit) if around else contextlib.nullcontext()):
        try:
            with rec:
                out = unit.run()
        except Exception as e:  # noqa: BLE001 - the failure is the fact
            return {"run_error": type(e).__name__}
    return rec.facts(args=args, out=out)


def entry_facts(units, around: Optional[Callable] = None) -> dict:
    """Facts for one manifest entry: per-unit fact dicts plus the
    dispatch count (len(units): the steps the host loop runs per logical
    step of this entrypoint)."""
    return {
        "dispatches": len(units),
        "units": {u.name: unit_facts(u, around) for u in units},
    }


def extract_entries(manifest: dict, names=None, device="cpu",
                    around: Optional[Callable] = None) -> dict:
    """{entry_name: facts} for the selected manifest entries (all when
    `names` is None), built on `device`. Each manifest value is a
    builder ``(device) -> [Unit, ...]``; building is deferred so
    ``--entries foo`` pays only foo's inputs."""
    selected = list(manifest) if names is None else list(names)
    unknown = [n for n in selected if n not in manifest]
    if unknown:
        raise KeyError(
            f"unknown manifest entries {unknown}; known: "
            f"{sorted(manifest)}")
    return {name: entry_facts(manifest[name](device), around)
            for name in selected}
