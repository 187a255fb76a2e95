"""What the harness and the metric readers share: loading a module of the
benchmark by its path, stage seconds per call from the run's hooked calls,
and the table of the cards' published peaks."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str, name: str):
    """The module in the file `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage_mean(rec: dict, names) -> float | None:
    """Mean seconds per hooked call of the named stages together; None
    when no hooked call reached any of them."""
    calls = [sum(st[n] for n in names if n in st) for st in rec["stages"]
             if any(n in st for n in names)]
    return sum(calls) / len(calls) if calls else None


def peak(card: str, what: str) -> float | None:
    """A published peak of the card (peaks.json), None for a card the
    table does not hold."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(card, {}).get(what)
