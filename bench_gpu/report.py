"""What a run prints: its log lines and checks on standard error, its
result as the last line of standard output. Imports no torch."""

from __future__ import annotations

import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tpudsp")


def log(msg: str):
    """One line on standard error, in one write."""
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (tpudsp_torch is not tpudsp)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def roofline_faults(res: dict) -> list:
    """Roofline shares above 100 %: the work is counted too high or the time
    leaves part of it out."""
    return [f"{k} = {v['value']:.4f} % is above 100 %"
            for k, v in res["metrics"].items() if k.endswith("_roofline") and v["value"] > 100.0]


def emit(res: dict, checks: list) -> int:
    """Print the checks as the last lines of standard error and the result as
    the last line of standard output; the exit code."""
    bad = roofline_faults(res)
    forbidden = forbidden_modules()
    if forbidden:
        bad.append(f"loaded after the window: {', '.join(forbidden)}")
    for b in bad:
        log(f"bench: {b}")
    for c in checks:
        why = f" ({c['why']})" if c.get("why") else ""
        log(f"check {c['name']}: {c['value']} limit {c['limit']} "
            f"{'ok' if c['ok'] else 'FAILED'}{why}")
    if bad:
        return 1
    print(json.dumps(res), flush=True)
    return 0
