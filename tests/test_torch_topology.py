"""Port congruence: topology tables, device tables and meta packing, plus the
port's import boundary and its device default.

Tables are integer data, held array-equal (no tolerance)."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import router as jrt
from repro.core.noc import topology as jtopo
from repro_torch.core.noc import router as trt
from repro_torch.core.noc import sim as tsim
from repro_torch.core.noc import topology as ttopo

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the paper grid plus the two non-square grids of tests/test_placement.py
GRIDS = [(6, 6, 8), (4, 5, 6), (4, 4, 8)]


@pytest.mark.parametrize("grid", GRIDS)
def test_topology_tables_equal(grid):
    j = jtopo.make_topology(*grid)
    t = ttopo.make_topology(*grid)
    assert (j.width, j.height, j.n_routers) == (t.width, t.height, t.n_routers)
    for name in ("route", "neighbor", "opposite", "node_type", "mc_ids"):
        np.testing.assert_array_equal(
            getattr(j, name), getattr(t, name), err_msg=name
        )
    for name in ("N_PORTS", "PORT_N", "PORT_E", "PORT_S", "PORT_W", "PORT_L",
                 "NT_CPU", "NT_GPU", "NT_MC", "MAX_ROUTERS"):
        assert getattr(jtopo, name) == getattr(ttopo, name), name


@pytest.mark.parametrize("grid", GRIDS)
def test_device_tables_equal(grid):
    jt = jrt.device_tables(jtopo.make_topology(*grid))
    tt = trt.device_tables(ttopo.make_topology(*grid), "cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("args", [(2, 8, 5), (1, 6, 2), (9, 8, 8), (2, 2, 4)])
def test_validate_topology_args_rejects_like_reference(args):
    with pytest.raises(ValueError) as je:
        jtopo.validate_topology_args(*args)
    with pytest.raises(ValueError) as te:
        ttopo.validate_topology_args(*args)
    assert str(je.value) == str(te.value)


def test_pack_meta_tables_equal():
    R = 36
    dest, src, cls = np.meshgrid(
        np.arange(R), np.arange(R), np.arange(2), indexing="ij"
    )
    d, s, c = (x.ravel().astype(np.int32) for x in (dest, src, cls))
    jm = np.asarray(jrt.pack_meta(jnp.asarray(d), jnp.asarray(s), jnp.asarray(c)))
    tm = trt.pack_meta(torch.from_numpy(d), torch.from_numpy(s),
                       torch.from_numpy(c))
    assert tm.dtype == torch.int16
    np.testing.assert_array_equal(jm, tm.numpy())
    for a, b in zip(jrt.unpack_meta(jnp.asarray(jm)), trt.unpack_meta(tm)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    """No module of the port, nor chip_smoke.py, nor a torch driver
    (benchmarks/torch_*.py) imports jax, repro or the JAX drivers' CLI
    helpers (benchmarks._cli)."""
    bad = []
    drivers = sorted((ROOT / "benchmarks").glob("torch_*.py"))
    assert len(drivers) >= 5
    for path in _port_files() + drivers:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
                names += [f"{node.module}.{a.name}" for a in node.names
                          if node.module == "benchmarks"]
            else:
                continue
            for n in names:
                if (n.split(".")[0] in ("jax", "jaxlib", "repro")
                        or n.startswith("benchmarks._cli")):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad
    # the walk covers every subpackage of the port, the serving and fleet
    # ones and their kernels included
    covered = {p.parent.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in _port_files()[:-1]}
    assert {"configs", "dist", "launch", "models", "serve",
            "kernels/kf_bank", "kernels/flash_attn",
            "kernels/mamba_scan"} <= covered


def test_simulate_defaults_to_cuda(monkeypatch):
    """Without ``device=`` the entry points (simulate, simulate_with_trace
    and the observing TraceRecorder) ask for CUDA and name the CPU escape
    hatch; they never silently run on the CPU."""
    from repro_torch.obs import TraceRecorder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsim.NoCConfig(mode="fair", n_epochs=1, epoch_len=2)
    for run in (tsim.simulate, tsim.simulate_with_trace,
                TraceRecorder(observe=True).record):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run(cfg, "PATH")


def test_fleet_and_serving_entry_points_default_to_cuda(monkeypatch):
    """Without a device the fleet and serving entry points, and the kernel
    wrappers handed arrays that are not tensors, ask for CUDA and name the
    CPU escape hatch; none of them runs on the CPU unasked."""
    import numpy as np

    import repro_torch.configs as configs
    from repro_torch.dist.kf_scheduler import FleetKF
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.kf_bank.ops import kf_bank_step
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, EngineConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke("llama3.2-3b")
    params = lm.make_lm(torch.Generator().manual_seed(0), cfg)
    x = np.zeros(4, np.float32)
    qkv = np.zeros((1, 8, 2, 64), np.float32)
    calls = (
        lambda: Engine(params, cfg, EngineConfig()),
        lambda: serve.run("llama3.2-3b", "kf", n_requests=2),
        lambda: FleetKF(16),
        lambda: lm.init_decode_state(2, 16, cfg),
        lambda: kf_bank_step(x, x + 1, np.zeros((4, 3), np.float32),
                             np.ones(3, np.float32), np.ones(3, np.float32)),
        lambda: flash_attention(qkv, qkv, qkv),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
