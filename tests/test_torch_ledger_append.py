"""The port's ledger append path (`repro_torch.obs.ledger.append`) against
the JAX package's (`repro.obs.ledger.append`), each on a file of its own
under a temp dir:

  * the same row comes back stamped alike (ledger_version, git sha and
    device kind: "cpu" in both here) and lands in the JSON array and the
    JSONL mirror alike;
  * the rows JAX refuses, the port refuses with the same message, and
    neither writes a file;
  * a torn tail line in the mirror is dropped by both, the rest kept, so
    both mirrors read the same afterwards;
  * the port's ledger is its own: BENCH_noc_torch.json at the root with
    its mirror LEDGER_noc_torch.jsonl, never BENCH_noc.json."""
import json
import os

import pytest

from repro.obs import ledger as jledger
from repro_torch.obs import ledger

ROW = {"bench": "noc_sweep_serial_vs_batched",
       "timestamp": "2026-01-01T00:00:00", "backend": "cpu",
       "speedup_steady": 1.25, "grid": {"n_points": 4}}
BAD_ROWS = {
    "no_bench": {k: v for k, v in ROW.items() if k != "bench"},
    "bench_not_str": {**ROW, "bench": 3},
    "timestamp_not_str": {**ROW, "timestamp": 20260101},
    "stamp_not_int": {**ROW, "ledger_version": "1"},
    "sha_not_str": {**ROW, "git_sha": 7},
    "too_new": {**ROW, "ledger_version": ledger.LEDGER_VERSION + 1},
    "not_a_dict": ["bench"],
}


def paths(tmp_path):
    out = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        out[name] = str(tmp_path / name / "BENCH.json")
    return out


def mirror(mod, path) -> str:
    with open(mod.jsonl_path(path)) as f:
        return f.read()


def test_append_stamps_and_writes_like_jax(tmp_path):
    p = paths(tmp_path)
    got = [ledger.append(dict(ROW), p["port"]),
           ledger.append({**ROW, "bench": "fleet_kf_epoch"}, p["port"])]
    want = [jledger.append(dict(ROW), p["jax"]),
            jledger.append({**ROW, "bench": "fleet_kf_epoch"}, p["jax"])]
    assert got == want
    assert got[0]["ledger_version"] == ledger.LEDGER_VERSION
    assert got[0]["device_kind"] == "cpu"
    for name, mod in (("jax", jledger), ("port", ledger)):
        with open(p[name]) as f:
            assert json.load(f) == got
    assert mirror(ledger, p["port"]) == mirror(jledger, p["jax"])
    assert [json.loads(line) for line in
            mirror(ledger, p["port"]).splitlines()] == got
    assert ledger.validate_row(got[0]) == []


def test_append_keeps_a_stamp_the_row_has(tmp_path):
    p = paths(tmp_path)
    row = {**ROW, "git_sha": "abc", "device_kind": "NVIDIA H100 80GB HBM3"}
    assert ledger.append(row, p["port"]) == jledger.append(row, p["jax"])


@pytest.mark.parametrize("case", sorted(BAD_ROWS))
def test_refuses_what_jax_refuses(tmp_path, case):
    p = paths(tmp_path)
    msgs = []
    for name, mod in (("jax", jledger), ("port", ledger)):
        with pytest.raises((ValueError, TypeError)) as e:
            mod.append(BAD_ROWS[case], p[name])
        msgs.append((e.type, str(e.value)))
        assert not os.path.exists(p[name])
        assert not os.path.exists(mod.jsonl_path(p[name]))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("tail", ["", "\n", '{"bench": "torn', "no newline"])
def test_torn_mirror_tail_repaired_like_jax(tmp_path, tail):
    p = paths(tmp_path)
    kept = json.dumps({"bench": "old", "timestamp": "t", "backend": "cpu"})
    for name, mod in (("jax", jledger), ("port", ledger)):
        with open(mod.jsonl_path(p[name]), "w") as f:
            f.write(kept + "\n" + tail)
        mod.append(dict(ROW), p[name])
    text = mirror(ledger, p["port"])
    assert text == mirror(jledger, p["jax"])
    lines = [line for line in text.splitlines() if line]
    assert json.loads(lines[0])["bench"] == "old"
    assert json.loads(lines[-1])["bench"] == ROW["bench"]
    assert all(json.loads(line) for line in lines)
    assert not os.path.exists(ledger.jsonl_path(p["port"]) + ".tmp")


def test_the_ports_ledger_is_its_own_file():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert ledger.BENCH_PATH == os.path.join(root, "BENCH_noc_torch.json")
    assert os.path.basename(ledger.jsonl_path(ledger.BENCH_PATH)) \
        == "LEDGER_noc_torch.jsonl"
    assert os.path.basename(jledger.jsonl_path(ledger.BENCH_PATH)) \
        == "LEDGER_noc.jsonl"
    assert ledger.append.__defaults__ == (ledger.BENCH_PATH,)
    from benchmarks import (torch_bench_fleet_kf, torch_bench_sweep,
                            torch_check_bench)
    for mod in (torch_bench_sweep, torch_bench_fleet_kf):
        assert mod.BENCH_PATH == ledger.BENCH_PATH
    assert torch_check_bench.bench_sweep.BENCH_PATH == ledger.BENCH_PATH
    with open(os.path.join(root, ".gitignore")) as f:
        assert "LEDGER_noc_torch.jsonl" in f.read().split()
