"""The program's own spans, for the readers of ``program_span`` metrics.

``records()`` is what ``highresnet_tpu_torch.utils.profiling.spans()``
holds after a traced run: the program records spans only while a profiler
runs, and in a run that is the traced calls alone. A program without spans
gives no records, and each reader then gives None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def records() -> List[dict]:
    try:
        from highresnet_tpu_torch.utils.profiling import spans
    except ImportError:  # a program that records no spans
        return []
    return spans()


def per(recs: List[dict], names: Iterable[str], key: str, items: float) -> Optional[float]:
    """The sum of ``key`` (``host_ms`` or ``device_ms``) over the records of
    ``names``, over ``items`` (scenes or steps); None where there is no such
    record, one lacks the value (no device time on the CPU) or no item."""
    values = [r[key] for r in recs if r["name"] in names]
    if not values or not items or any(v is None for v in values):
        return None
    return sum(values) / items


def steps(recs: List[dict]) -> int:
    """The train steps recorded: the ``train.step`` spans."""
    return sum(r["name"] == "train.step" for r in recs)
