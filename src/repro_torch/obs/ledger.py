"""The port's run ledger: the single append path for BENCH_noc_torch.json.

Every row the port's drivers record (`benchmarks/torch_bench_sweep.py`'s
`append_record`, which the other torch drivers import) goes through
`append`, which

  * stamps the row with provenance (`ledger_version`, `git_sha`,
    `device_kind`: the CUDA card's name, or "cpu") on top of the fields
    the bench recorded (`bench`, `timestamp`, `backend`, ...);
  * validates the row against the schema below and refuses to write a
    malformed one;
  * appends to the JSON array at its path AND mirrors the row as one
    JSONL line to LEDGER_noc_torch.jsonl beside it (gitignored), through
    a temp file and `os.replace`.

The port's ledger is a file of its own, BENCH_noc_torch.json at the root
of the repository: BENCH_noc.json holds the JAX package's rows and the
port never writes it.  `git_sha`, `config_hash`, `run_stamp`,
`validate_row` and the append path are the JAX package's.
`validate_row` is also the gate `benchmarks/torch_check_bench.py` runs
over every row.
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
# Fields `append` stamps; present on every row written through it.
STAMP_FIELDS = {"ledger_version": int, "git_sha": str, "device_kind": str}
# The ledger files, at the root of the repository (src/repro_torch/obs/..).
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BENCH_PATH = os.path.join(ROOT, "BENCH_noc_torch.json")
JSONL_NAME = "LEDGER_noc_torch.jsonl"


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


def jsonl_path(bench_path: str) -> str:
    """The JSONL mirror beside the bench array at ``bench_path``."""
    return os.path.join(os.path.dirname(os.path.abspath(bench_path)),
                        JSONL_NAME)


def _append_jsonl_atomic(rec: dict, path: str) -> None:
    """Crash-safe JSONL mirror append: the existing lines plus the new one
    are written to a temp file in the same directory and `os.replace`d over
    the mirror, so readers see the old file or the new one, never a torn
    line.  A torn tail line left by an earlier interrupted writer is
    dropped rather than glued onto the new row.  One retry absorbs a
    transient OSError."""
    existing = ""
    if os.path.exists(path):
        with open(path) as f:
            existing = f.read()
        if existing and not existing.endswith("\n"):
            existing = existing[:existing.rfind("\n") + 1]
    line = json.dumps(rec, sort_keys=True) + "\n"
    tmp = path + ".tmp"
    for attempt in (0, 1):
        try:
            with open(tmp, "w") as f:
                f.write(existing + line)
            os.replace(tmp, path)
            return
        except OSError:
            if attempt:
                raise


def append(rec: dict, path: str = BENCH_PATH) -> dict:
    """Stamp, validate, and append ``rec`` to the bench array at ``path``
    (default: the port's BENCH_noc_torch.json).

    Returns the stamped record.  Raises ValueError instead of writing a
    row that fails the schema: a malformed row would turn the
    torch_check_bench gate red for every later run.
    """
    rec = dict(rec)
    for field, value in run_stamp().items():
        rec.setdefault(field, value)
    problems = validate_row(rec, stamped=True)
    if problems:
        raise ValueError(f"ledger row rejected: {problems} in {rec!r}")

    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    else:
        records = []
    records.append(rec)
    with open(path, "w") as f:
        json.dump(records, f, indent=2)
        f.write("\n")
    _append_jsonl_atomic(rec, jsonl_path(path))
    return rec
