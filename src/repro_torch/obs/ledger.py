"""The pure half of the run ledger: provenance stamps and the row schema.

`git_sha`, `config_hash`, `run_stamp` and `validate_row` are the JAX
package's (`device_kind` names the CUDA card, or "cpu").  The append path
that writes BENCH_noc.json is not here: that file holds the JAX package's
rows, and the port's drivers print their rows as JSON and append nowhere
until the port has a ledger file of its own.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
from typing import Any

LEDGER_VERSION = 1

# Fields every bench row must carry, ledger-stamped or not.
CORE_FIELDS = {"bench": str, "timestamp": str, "backend": str}
# Fields a stamp adds; present on every row written through a ledger.
STAMP_FIELDS = {"ledger_version": int, "git_sha": str, "device_kind": str}


def git_sha(cwd: str | None = None) -> str:
    """Current commit sha, or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_kind() -> str:
    """The CUDA card's name (torch.cuda.get_device_name(0)), "cpu" without
    one; never raises."""
    try:
        import torch

        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name(0))
        return "cpu"
    except Exception:
        return "unknown"


def config_hash(obj: Any) -> str:
    """Stable short hash of a config (dataclass, namedtuple, or dict)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    elif hasattr(obj, "_asdict"):
        obj = obj._asdict()
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def run_stamp() -> dict:
    return {
        "ledger_version": LEDGER_VERSION,
        "git_sha": git_sha(),
        "device_kind": device_kind(),
    }


def validate_row(row: Any, stamped: bool | None = None) -> list:
    """Return the list of schema problems (empty = valid).

    stamped=None infers from the row: a `ledger_version` key means the
    row was stamped and must carry the full stamp.
    """
    problems = []
    if not isinstance(row, dict):
        return [f"row is {type(row).__name__}, expected object"]
    for field, typ in CORE_FIELDS.items():
        if field not in row:
            problems.append(f"missing required field {field!r}")
        elif not isinstance(row[field], typ):
            problems.append(
                f"field {field!r} is {type(row[field]).__name__}, "
                f"expected {typ.__name__}"
            )
    if stamped is None:
        stamped = "ledger_version" in row
    if stamped:
        for field, typ in STAMP_FIELDS.items():
            if field not in row:
                problems.append(f"missing stamp field {field!r}")
            elif not isinstance(row[field], typ):
                problems.append(
                    f"stamp field {field!r} is {type(row[field]).__name__}, "
                    f"expected {typ.__name__}"
                )
        ver = row.get("ledger_version")
        if isinstance(ver, int) and ver > LEDGER_VERSION:
            problems.append(
                f"ledger_version {ver} is newer than this validator "
                f"({LEDGER_VERSION})"
            )
    return problems
