"""Regression corpus: serialized shrunk timelines under
``tests/regressions/``.

Every fuzz find becomes a permanent tier-1 test: the shrunk timeline is
saved as ``<name>.json`` (canonical indented JSON, provenance included)
and the corpus tests replay every file through the full differential
harness on each run.  The port reads the same directory as the JAX
package's fuzzer: one corpus holds both to the same finds.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..sim.generate import GeneratedTimeline, timeline_from_dict

__all__ = ["corpus_dir", "save_timeline", "load_timeline", "iter_corpus"]


def corpus_dir(root: str | Path | None = None) -> Path:
    """The corpus directory (default: ``tests/regressions`` next to the
    repo's ``src/``; resolved relative to this file so tools and tests
    agree without configuration)."""
    if root is not None:
        return Path(root)
    return Path(__file__).resolve().parents[3] / "tests" / "regressions"


def save_timeline(d: dict, name: str,
                  directory: str | Path | None = None) -> Path:
    """Write one serialized timeline to the corpus; returns the path."""
    directory = corpus_dir(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{name}.json"
    path.write_text(json.dumps(d, sort_keys=True, indent=1) + "\n")
    return path


def load_timeline(path: str | Path) -> GeneratedTimeline:
    return timeline_from_dict(json.loads(Path(path).read_text()))


def iter_corpus(directory: str | Path | None = None) -> list[Path]:
    """Sorted corpus file paths (empty when the corpus doesn't exist)."""
    directory = corpus_dir(directory)
    if not directory.is_dir():
        return []
    return sorted(directory.glob("*.json"))
