"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips when no CUDA device is present (decided
inside the test, never at import).  chip_smoke.py runs the same checks at
the paper shapes; run these on a card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import sim, traffic
from repro_torch.kernels.mamba_scan import fused as ms_fused
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan.ref import scan_ref
from repro_torch.kernels.noc_cycle import fused, ops


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _lane_rows(g, L=256, PV=20, V=4):
    """Random (rows, L) int32 lane rows in fused.lane_arbitrate's order."""
    def ri(lo, hi, rows):
        return torch.randint(lo, hi, (rows, L), generator=g, device="cuda",
                             dtype=torch.int32)

    return (ri(0, 2, PV), ri(0, 2, PV), ri(0, 5, PV), ri(0, PV, 5),
            ri(0, 5, PV), ri(0, 2, 5), ri(0, 2, V), ri(0, 2, V),
            ri(-1, 2, 1), ri(0, 2, 1), ri(0, 2, 1))


@pytest.mark.cuda
def test_arbitration_kernel_matches_plain():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(4):
        ins = _lane_rows(g)
        k = ops.arbitrate_rows(*ins, depth=4)
        v, c, o, rr, dn, ex, gm, cm, sa, acc, act = ins
        p = fused.lane_arbitrate(v != 0, c, o, rr, dn, ex != 0, gm != 0,
                                 cm != 0, sa, acc != 0, act != 0, depth=4)
        for name, a, b in zip(fused.LaneArb._fields, k, p):
            assert torch.equal(a.to(torch.int32), b.to(torch.int32)), name


def _dense_operands(seed, dev="cuda"):
    """The 11 operands `router.router_cycle` hands its arbitration function
    for one cycle of a random dense state on the card: bool and int32
    tensors, broadcast views among them."""
    from repro_torch.core.noc import router as rt
    from repro_torch.core.noc.topology import make_topology

    g = torch.Generator(device=dev).manual_seed(seed)
    S, R, P, V, B = 4, 36, 5, 4, 4

    def ri(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    shape = (S, R, P, V)
    meta = ri(R, shape + (B,)) + (ri(R, shape + (B,)) << 6) \
        + (ri(2, shape + (B,)) << 12)
    state = rt.SubnetState(
        buf_meta=meta.to(torch.int16), buf_binj=ri(5000, shape + (B,)),
        head=ri(B, shape, torch.int8), count=ri(B + 1, shape, torch.int8),
        rr_ptr=ri(P * V, (S, R, P), torch.int8))
    seen = []

    def record(*args, depth):
        seen.append((args, depth))
        return rt.arbitrate(*args, depth=depth)

    rt.router_cycle(
        state, *rt.device_tables(make_topology(), dev)[:3],
        ri(2, (S, V)) != 0, ri(2, (S, V)) != 0,
        torch.tensor(seed % 3 - 1, dtype=torch.int32, device=dev),
        ri(5, (S, R)) != 0, torch.tensor([True, True, False, True],
                                         device=dev),
        arbitrate_fn=record, link_ok=ri(10, (R, P)) != 0,
        router_ok=ri(10, (R,)) != 0)
    (args, depth), = seen
    return args, depth


def _launches(fn, n):
    """``n`` calls of ``fn`` under torch.profiler: the kernel launches the
    host made (its launch calls on the CPU side) and the names of the
    device kernels recorded (the card's tracing can drop device records; a
    session that records fewer kernels than launches is run again, up to
    three times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        launches = sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CPU
                       and "LaunchKernel" in e.name)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(names) >= launches:
            break
    return launches, names


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arbitrate_lanes_kernel_matches_plain_on_dense_operands(seed):
    """B1's dense entry on router_cycle's own operands (expanded views,
    bool and int32), and on the same values as int8 / uint8 / int64 and
    non-contiguous views, against `router.arbitrate` on the card, bitwise,
    in its shapes and dtypes; one launch a call."""
    _need_cuda()
    from repro_torch.core.noc import router as rt

    args, depth = _dense_operands(seed)
    va, cl, op, rr, dn, ex, gm, cm, sa, acc, act = args
    S, R = va.shape[:2]
    want = rt.arbitrate(*args, depth=depth)
    variants = [args, (
        va.to(torch.uint8), cl.to(torch.int8), op.to(torch.int64),
        rr.to(torch.int8), dn.to(torch.int8).transpose(0, 1).contiguous()
        .transpose(0, 1), ex.to(torch.int8), gm.expand(S, R, 4), cm,
        sa[0, 0], acc.to(torch.uint8), act)]
    for k, ins in enumerate(variants):
        ops.reset_launches()
        got = ops.arbitrate_lanes(*ins, depth=depth)
        assert ops.LAUNCHES["noc_arbitrate"] == 1
        for name, a, b in zip(want._fields, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, (k, name)
            assert torch.equal(a, b), (k, name)


@pytest.mark.cuda
def test_arbitrate_entry_points_are_one_kernel_each():
    """`arbitrate_lanes` on the dense operands and `arbitrate_rows` on lane
    rows each run exactly one device kernel a call, B1's, and count one
    launch a call."""
    _need_cuda()
    args, depth = _dense_operands(3)
    rows = _lane_rows(torch.Generator(device="cuda").manual_seed(3))
    for fn in (lambda: ops.arbitrate_lanes(*args, depth=depth),
               lambda: ops.arbitrate_rows(*rows, depth=4)):
        ops.reset_launches()
        for _ in range(3):
            fn()
        assert ops.LAUNCHES["noc_arbitrate"] == 3
        launches, names = _launches(fn, 5)
        assert launches == 5 and names, (launches, names)
        assert all("noc_arbitrate_kernel" in n for n in names), names


@pytest.mark.cuda
def test_arbitration_refuses_uninstantiated_vcs():
    """V = 2 has no B1 instantiation: the wrappers raise on the card and
    launch nothing (no fallback to the plain version)."""
    _need_cuda()
    args, depth = _dense_operands(4)
    two = list(args)
    two[0], two[1], two[2] = (x.reshape(*x.shape[:-1], 5, 4)[..., :2]
                              .reshape(*x.shape[:-1], 10) for x in args[:3])
    two[4], two[6], two[7] = args[4][..., :2], args[6][..., :2], \
        args[7][..., :2]
    rows = list(_lane_rows(torch.Generator(device="cuda").manual_seed(4)))
    rows[0], rows[1], rows[2] = (x[:10] for x in rows[:3])
    rows[4], rows[6], rows[7] = rows[4][:10], rows[6][:2], rows[7][:2]
    ops.reset_launches()
    with pytest.raises(ValueError, match="V=2"):
        ops.arbitrate_lanes(*two, depth=depth)
    with pytest.raises(ValueError, match="V=2"):
        ops.arbitrate_rows(*rows, depth=4)
    assert ops.LAUNCHES["noc_arbitrate"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(7, 3), (1000, 5), (65_536, 3)])
def test_fleet_epoch_is_one_launch_equal_to_plain(n, m):
    """FleetKF.epoch on the card (B4 with the signal fused in) against
    `kf_bank_epoch_plain` on the card over 5 epochs, bitwise in x, p and
    the signals; one launch and one device kernel an epoch; the previous
    x and p are left as they were."""
    _need_cuda()
    from repro_torch.dist.kf_scheduler import FleetKF, SchedulerConfig
    from repro_torch.kernels.kf_bank import ops as kf_ops

    g = torch.Generator(device="cuda").manual_seed(n + m)
    cfg = SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    fleet = FleetKF(n, cfg, h=tuple(0.5 + 0.25 * k for k in range(m)))
    x, p = fleet.x, fleet.p
    kf_ops.reset_launches()
    for t in range(5):
        z = 0.7 * torch.randn((n, m), generator=g, device="cuda")
        x0, p0 = fleet.x.clone(), fleet.p.clone()
        held = fleet.x
        sig = fleet.epoch(z)
        assert kf_ops.LAUNCHES["kf_bank"] == t + 1
        assert torch.equal(held, x0) and fleet.x.data_ptr() != x0.data_ptr()
        x, p, want = kf_ops.kf_bank_epoch_plain(x, p, z, fleet.h, fleet.r,
                                                a=1.0, q=cfg.kf_q)
        assert sig.dtype == torch.int32 and torch.equal(sig, want), t
        assert torch.equal(fleet.x, x) and torch.equal(fleet.p, p), t
        assert not torch.equal(fleet.p, p0), t
    z = torch.randn((n, m), generator=g, device="cuda")
    launches, names = _launches(lambda: fleet.epoch(z), 4)
    assert launches == 4 and names, (launches, names)
    assert all("kf_bank_kernel" in k for k in names), names


@pytest.mark.cuda
def test_fleet_epoch_refuses_a_misshapen_observation():
    _need_cuda()
    from repro_torch.dist.kf_scheduler import FleetKF
    from repro_torch.kernels.kf_bank import ops as kf_ops

    fleet = FleetKF(64)
    kf_ops.reset_launches()
    for z in (torch.zeros((64, 4), device="cuda"),
              torch.zeros((3, 64), device="cuda").T):
        with pytest.raises(ValueError, match="z must be"):
            fleet.epoch(z)
    assert kf_ops.LAUNCHES["kf_bank"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kf", "4subnet"])
def test_engines_agree_on_card(mode):
    _need_cuda()
    cfg = sim.NoCConfig(mode=mode, n_epochs=4, epoch_len=100,
                        policy=PolicyConfig(warmup=200, hold=100, revert=300))
    res = [
        sim.simulate(cfg, "SHIFT_PATH_BFS", device="cuda", engine=e,
                     rng=torch.Generator(device="cuda").manual_seed(3))
        for e in ("fused", "arb", "ref")
    ]
    for r in res[1:]:
        for a, b in zip(res[0].counters, r.counters):
            assert torch.equal(a, b)
        assert torch.equal(res[0].applied_config, r.applied_config)


def _small_cfg(mode, **kw):
    return sim.NoCConfig(mode=mode, n_epochs=4, epoch_len=100,
                         policy=PolicyConfig(warmup=200, hold=100, revert=300),
                         **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("mode", ["kf", "4subnet", "fair", "baseline"])
def test_fused_kernel_matches_plain(mode, donate):
    """B2 against `cycle_steps_lanes` from a filled state (60 cycles in),
    after 1, 50 and 500 cycles, bitwise on every LaneState field.  With
    ``donate`` the kernel updates the arrays it is handed; without, it
    leaves them as they were."""
    _need_cuda()
    dev = torch.device("cuda")
    cfg = sim.NoCConfig(mode=mode, n_epochs=2, epoch_len=560,
                        policy=PolicyConfig(warmup=200, hold=100, revert=300))
    run = sim.run_inputs(cfg, "SHIFT_PATH_BFS", device=dev,
                         rng=torch.Generator(device=dev).manual_seed(2))
    tables = sim.lane_tables(run)
    d = tables[0]
    subs, mc, outst, backlog = sim.init_sim_state(run.stc, dev)
    st = fused.pack_state(d, subs, mc, outst, backlog,
                          traffic.init_phase().to(dev))
    ep = sim.epoch_inputs(run, 0, torch.tensor(1, dtype=torch.int32), 0)
    xi, xf, consts = sim.lane_row(*sim.lane_inputs(run, tables, ep), 0)
    st = ops.fused_cycle_step(d, st, xi[:60], xf[:60], *consts)  # fill
    assert int(st.count.sum()) > 0
    kept = fused.LaneState(*(x.clone() for x in st))
    for n in (1, 50, 500):
        p = fused.cycle_steps_lanes(d, st, xi[60:60 + n], xf[60:60 + n],
                                    *consts)
        src = fused.LaneState(*(x.clone() for x in st)) if donate else st
        k = ops.fused_cycle_step(d, src, xi[60:60 + n], xf[60:60 + n],
                                 *consts, donate=donate)
        for name, a, b, x in zip(fused.LaneState._fields, k, p, src):
            assert torch.equal(a, b), (n, name)
            assert (a.data_ptr() == x.data_ptr()) == donate, (n, name)
        for name, a, b in zip(fused.LaneState._fields, st, kept):
            assert torch.equal(a, b), (n, "input changed", name)


@pytest.mark.cuda
def test_fused_kernel_batch_matches_plain():
    """B2 on a batch of three runs (kf / 4subnet / fair, two seeds) in one
    launch against the plain version walking the rows, from states 60
    cycles in, after 1 and 300 cycles; and each row against a launch of
    its own."""
    _need_cuda()
    dev = torch.device("cuda")
    cfgs = [sim.NoCConfig(mode=m, seed=s, n_epochs=2, epoch_len=400,
                          policy=PolicyConfig(warmup=200, hold=100,
                                              revert=300))
            for m, s in (("kf", 0), ("4subnet", 1), ("fair", 0))]
    run = sim.batch_inputs(cfgs, "SHIFT_PATH_BFS", device=dev)
    tables = sim.lane_tables(run)
    d = tables[0]
    subs, mc, outst, backlog = sim.init_sim_state(run.stc, dev, n_rows=3)
    st = fused.pack_state(d, subs, mc, outst, backlog,
                          torch.zeros(3, dtype=torch.int32, device=dev))
    ep = sim.epoch_inputs(run, 0, torch.tensor([1, 0, 1], dtype=torch.int32),
                          0)
    xi, xf, consts = sim.lane_inputs(run, tables, ep)
    ops.reset_launches()
    st = ops.fused_cycle_step(d, st, xi[:, :60], xf[:, :60], *consts)
    assert ops.LAUNCHES["noc_fused_cycles"] == 1
    assert int(st.count.sum()) > 0
    for n in (1, 300):
        k = ops.fused_cycle_step(d, st, xi[:, 60:60 + n], xf[:, 60:60 + n],
                                 *consts)
        p = fused.cycle_steps_lanes(d, st, xi[:, 60:60 + n],
                                    xf[:, 60:60 + n], *consts)
        for name, a, b in zip(fused.LaneState._fields, k, p):
            assert torch.equal(a, b), (n, name)
        for b in range(3):
            xb, fb, cb = sim.lane_row(xi[:, 60:60 + n], xf[:, 60:60 + n],
                                      consts, b)
            alone = ops.fused_cycle_step(
                d, fused.LaneState(*(x[b] for x in st)), xb, fb, *cb)
            for name, a, c in zip(fused.LaneState._fields, k, alone):
                assert torch.equal(a[b], c), (n, b, name)


@pytest.mark.cuda
def test_simulate_batch_equals_standalone_on_card():
    """simulate_batch of mixed modes and seeds (a ragged tile) equals each
    row's standalone simulate bitwise, one B2 launch an epoch a tile."""
    _need_cuda()
    cfgs = [_small_cfg(m, seed=s) for m, s in
            (("kf", 0), ("fair", 1), ("4subnet", 0), ("kf", 1),
             ("baseline", 2))]
    ops.reset_launches()
    res = sim.simulate_batch(cfgs, "SHIFT_PATH_BFS", batch_tile=3)
    assert ops.LAUNCHES["noc_fused_cycles"] == 2 * cfgs[0].n_epochs
    for b, cfg in enumerate(cfgs):
        alone = sim.simulate(cfg, "SHIFT_PATH_BFS")
        for f, x, y in zip(sim.SimResult._fields, res, alone):
            pairs = zip(x, y) if f == "counters" else [(x, y)]
            for xx, yy in pairs:
                assert torch.equal(xx[b], yy), (b, f)


@pytest.mark.cuda
def test_probed_kernel_matches_plain():
    """B3 against `cycle_steps_lanes(..., probe=...)` from a non-zero
    carry, after 1 and 50 cycles, bitwise on every field."""
    _need_cuda()
    dev = torch.device("cuda")
    run = sim.run_inputs(_small_cfg("kf"), "SHIFT_PATH_BFS", device=dev,
                         rng=torch.Generator(device=dev).manual_seed(1))
    tables = sim.lane_tables(run)
    d = tables[0]
    subs, mc, outst, backlog = sim.init_sim_state(run.stc, dev)
    st = fused.pack_state(d, subs, mc, outst, backlog,
                          traffic.init_phase().to(dev))
    ep = sim.epoch_inputs(run, 0, torch.tensor(1, dtype=torch.int32), 0)
    xi, xf, consts = sim.lane_row(*sim.lane_inputs(run, tables, ep), 0)
    st = ops.fused_cycle_step(d, st, xi[:60], xf[:60], *consts)  # fill
    pb = fused.zero_probe(d, dev)
    _, pb = ops.fused_cycle_step(d, st, xi[:7], xf[:7], *consts, probe=pb)
    for n in (1, 50):
        k, kp = ops.fused_cycle_step(d, st, xi[60:60 + n], xf[60:60 + n],
                                     *consts, probe=pb)
        p, pp = fused.cycle_steps_lanes(d, st, xi[60:60 + n], xf[60:60 + n],
                                        *consts, probe=pb)
        for name, a, b in zip(fused.LaneState._fields, k, p):
            assert torch.equal(a, b), (n, name)
        for name, a, b in zip(fused.ProbeLanes._fields, kp, pp):
            assert torch.equal(a, b), (n, "probe", name)


@pytest.mark.cuda
def test_engines_agree_on_trace_on_card():
    _need_cuda()
    cfg = _small_cfg("kf", guard=True)
    outs = {
        e: sim.simulate_with_trace(
            cfg, "SHIFT_PATH_BFS", device="cuda", engine=e,
            rng=torch.Generator(device="cuda").manual_seed(3))
        for e in ("fused", "arb", "ref")
    }
    _, tf = outs["fused"]
    for e in ("arb", "ref"):
        _, t = outs[e]
        for name, a, b in zip(tf._fields, tf, t):
            assert torch.equal(a, b) or torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True), (e, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(7, 3), (1000, 5), (65_536, 3)])
def test_kf_bank_kernel_matches_plain(n, m):
    """B4 against `kf_bank_step_plain` on the card, bitwise (both round
    every operation once, in the same order)."""
    _need_cuda()
    from repro_torch.kernels.kf_bank import kernel as kf_kernel
    from repro_torch.kernels.kf_bank import ops as kf_ops

    g = torch.Generator(device="cuda").manual_seed(n)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device="cuda")

    x, p, z = torch.randn(n, generator=g, device="cuda"), u(n, 0.1, 2.0), \
        torch.randn((n, m), generator=g, device="cuda")
    h, r = u(m, 0.5, 1.5), u(m, 0.05, 0.5)
    for a, q in ((1.0, 1e-3), (0.9, 1e-2)):
        kx, kp = kf_kernel.kf_bank(x, p, z, h, r, a=a, q=q)
        px, pp = kf_ops.kf_bank_step_plain(x, p, z, h, r, a=a, q=q)
        assert torch.equal(kx, px) and torch.equal(kp, pp), (n, m, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,cap,kv_len", [
    (2, 48, 48, 6, 2, 64, True, None, None, None),
    (1, 200, 200, 24, 8, 128, True, None, None, None),
    (1, 200, 200, 32, 8, 80, True, 64, None, None),
    (1, 130, 130, 48, 8, 128, True, None, 30.0, None),
    (2, 64, 100, 8, 2, 128, False, None, None, 77),
    # bf16 runs the wgmma kernel on 128-row tiles: Sq off the tile, Sk != Sq
    # with kv_len, D = 80 padded to 128 in shared memory and D = 64 in one
    # box, a window spanning tiles, the logit cap, two batch rows, no key
    (1, 300, 300, 24, 8, 128, True, None, None, None),
    (1, 200, 333, 24, 8, 128, True, None, None, 250),
    (1, 333, 200, 8, 8, 128, False, None, None, 150),
    (1, 517, 517, 32, 8, 80, True, None, None, None),
    (2, 300, 300, 8, 1, 64, True, None, None, None),
    (1, 700, 700, 16, 8, 128, True, 200, None, None),
    (1, 700, 700, 32, 8, 80, True, 300, None, None),
    (2, 384, 384, 48, 8, 128, True, None, 30.0, None),
    (2, 256, 256, 8, 2, 128, False, None, None, 0),
    # llama4-maverick (GQA groups of 5) and grok-1 (groups of 6, capped)
    (1, 517, 517, 40, 8, 128, True, None, None, None),
    (1, 300, 300, 48, 8, 128, True, None, 30.0, None),
    # seamless-m4t's encoder (H = KV = 16, D = 64, no mask), with and
    # without kv_len, and its decoder (causal); internvl2 (groups of 2)
    (1, 600, 600, 16, 16, 64, False, None, None, None),
    (2, 333, 333, 16, 16, 64, False, None, None, 201),
    (1, 517, 517, 16, 16, 64, True, None, None, None),
    (1, 300, 300, 16, 8, 128, True, None, None, None),
])
def test_flash_kernel_matches_plain(dtype, b, sq, sk, h, kv, d, causal,
                                    window, cap, kv_len):
    """B5 against `flash_attention_plain` on the card.  f32 (the SIMT
    kernel): atol 2e-5, rtol 1e-5 (summation order, expf; TF32 is off,
    torch's default, so the plain products are full f32).  bf16 (the wgmma
    kernel): atol 8e-3 plus rtol 2^-7, one bf16 ulp of the value; the
    kernel feeds P to the PV product in bf16 where the plain version keeps
    it in f32, an error of at most 2^-9 of each p * v term, and both round
    the output to bf16, where a last-bit difference can fall on either side
    of a rounding boundary."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(sq + d)
    q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, sk, kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, sk, kv, d), generator=g, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap, kv_len=kv_len)
    out = fa_kernel.flash_attn(q, k, v, **kw)
    want = fa_ops.flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=8e-3, rtol=2 ** -7)
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.cuda
def test_flash_kernel_reads_fused_qkv_views():
    """q, k and v as strided views of one fused (B, S, H + 2 KV, D) bf16
    tensor: the kernel reads them in place through their strides."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    b, s, h, kv, d = 2, 260, 24, 8, 128
    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn((b, s, h + 2 * kv, d), generator=g,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous() and k.stride(1) == (h + 2 * kv) * d
    before = fa_ops.LAUNCHES["flash_attn"]
    out = fa_kernel.flash_attn(q, k, v, causal=True, window=None,
                               logit_cap=None, kv_len=None)
    assert fa_ops.LAUNCHES["flash_attn"] == before + 1
    want = fa_ops.flash_attention_plain(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
    torch.testing.assert_close(out.float(), want.float(), atol=8e-3,
                               rtol=2 ** -7)


@pytest.mark.cuda
def test_flash_kernel_rejects_misaligned_strides():
    """TMA needs strides that are multiples of 16 bytes: a bf16 view whose
    row stride is not raises before any launch; f32 (the SIMT kernel)
    takes the same view."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    base = torch.randn((1, 64, 8, 68), device="cuda")
    kw = dict(causal=True, window=None, logit_cap=None, kv_len=None)
    q = base.to(torch.bfloat16)[..., :64]   # stride on H: 68 elements
    k = torch.randn((1, 64, 2, 64), device="cuda").to(torch.bfloat16)
    before = fa_ops.LAUNCHES["flash_attn"]
    with pytest.raises(ValueError, match="not TMA-aligned"):
        fa_kernel.flash_attn(q, k, k, **kw)
    assert fa_ops.LAUNCHES["flash_attn"] == before
    out = fa_kernel.flash_attn(base[..., :64], k.float(), k.float(), **kw)
    want = fa_ops.flash_attention_plain(base[..., :64], k.float(), k.float())
    torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-5)


BWD_CASES = [
    # b, s, h, kv, d, causal, window, cap
    (2, 48, 6, 2, 64, True, None, None),
    (1, 200, 24, 8, 128, True, None, None),
    (1, 300, 32, 8, 80, True, 64, None),
    (1, 130, 48, 8, 128, True, None, 30.0),
    (1, 100, 8, 2, 128, False, None, None),
    (1, 517, 40, 8, 128, True, None, None),
    (1, 517, 32, 32, 80, True, None, None),
    # the bf16 kernels' tiles (128 keys x 64 queries, 128 queries x 64
    # keys) at each width with a window and the cap, groups of 1, 3 and 5,
    # Sq off the tiles
    (1, 333, 15, 5, 64, True, 100, 20.0),
    (2, 190, 10, 2, 80, True, 48, 30.0),
    (1, 250, 8, 8, 128, True, 70, 30.0),
    # seamless-m4t's encoder (no mask) at D = 64 with H = KV = 16, its
    # decoder (causal), and internvl2's groups of 2
    (1, 333, 16, 16, 64, False, None, None),
    (2, 190, 16, 16, 64, False, None, None),
    (1, 300, 16, 16, 64, True, None, None),
    (1, 300, 16, 8, 128, True, None, None),
]


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window,cap", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(dtype, b, s, h, kv, d, causal,
                                        window, cap):
    """B5-bwd against `flash_attention_plain_bwd` on the same inputs (o and
    lse are B5's own outputs): relative L2 of dq, dk and dv <= 1e-5 in f32
    (f32 sums in another order; TF32 off) and <= 1e-2 in bf16 (the wgmma
    kernels round P and dS to bf16 for their products where the plain
    version keeps f32, and both round the gradients to bf16 once).  Two
    launches give the same bits (no atomics)."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(s + d)
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, kv, d), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    o, lse = fa_kernel.flash_attn(q, k, v, kv_len=None, with_lse=True, **kw)
    before = fa_ops.LAUNCHES["flash_attn_bwd"]
    got = fa_kernel.flash_attn_bwd(q, k, v, o, do, lse, **kw)
    again = fa_kernel.flash_attn_bwd(q, k, v, o, do, lse, **kw)
    assert fa_ops.LAUNCHES["flash_attn_bwd"] == before + 2
    want = fa_ops.flash_attention_plain_bwd(q, k, v, o, do, **kw)
    bound = 1e-5 if dtype == torch.float32 else 1e-2
    for name, x, y, z in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == dtype and x.shape == z.shape, name
        assert torch.equal(x, y), f"{name} differs between two launches"
        assert _rel_l2(x, z) <= bound, (name, _rel_l2(x, z))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,window,cap,kv_len", [
    (2, 48, 6, 2, 64, None, None, None),
    (1, 300, 24, 8, 128, None, 30.0, None),
    (1, 517, 32, 8, 80, 64, None, None),
    (1, 200, 8, 2, 128, 8, None, 20),     # rows 27.. see no key: lse 0
])
def test_flash_kernel_lse_matches_plain_and_keeps_o(dtype, b, s, h, kv, d,
                                                   window, cap, kv_len):
    """B5 asked for the rows' log-sum-exp: lse within 1e-5 of the plain
    version's (abs, plus 1e-5 rel: the kernel's online max and sum, ex2 /
    expf), 0 on rows with no valid key, and O bitwise the O of a launch
    that writes no lse."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    kw = dict(causal=True, window=window, logit_cap=cap, kv_len=kv_len)
    plain_o = fa_kernel.flash_attn(q, k, v, **kw)
    o, lse = fa_kernel.flash_attn(q, k, v, with_lse=True, **kw)
    _, want = fa_ops.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, plain_o)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
    if kv_len is not None:
        dead = torch.arange(s, device="cuda") - window + 1 >= kv_len
        assert bool(dead.any()) and not bool(lse[..., dead].any())


@pytest.mark.cuda
def test_flash_bwd_rejects_what_it_cannot_take():
    """bf16 dO whose strides TMA cannot read, and an lse of the wrong shape
    or type, raise before any launch."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    q = torch.randn((1, 64, 4, 64), device="cuda").to(torch.bfloat16)
    k = torch.randn((1, 64, 2, 64), device="cuda").to(torch.bfloat16)
    kw = dict(causal=True, window=None, logit_cap=None)
    o, lse = fa_kernel.flash_attn(q, k, k, kv_len=None, with_lse=True, **kw)
    do = torch.randn((1, 64, 4, 68), device="cuda").to(torch.bfloat16)
    before = fa_ops.LAUNCHES["flash_attn_bwd"]
    with pytest.raises(ValueError, match="not TMA-aligned"):
        fa_kernel.flash_attn_bwd(q, k, k, o, do[..., :64], lse, **kw)
    with pytest.raises(ValueError, match="lse"):
        fa_kernel.flash_attn_bwd(q, k, k, o, o, lse[:, :2], **kw)
    with pytest.raises(ValueError, match="lse"):
        fa_kernel.flash_attn_bwd(q, k, k, o, o, lse.double(), **kw)
    assert fa_ops.LAUNCHES["flash_attn_bwd"] == before


@pytest.mark.cuda
def test_flash_attention_gradients_reach_qkv_on_card():
    """Under autograd on CUDA tensors, q, k and v get gradients through
    FlashAttention: one B5 launch forward, one B5-bwd call backward, and
    the gradients are B5-bwd's; a kv_len raises in the backward."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(torch.bfloat16).requires_grad_()
               for shape in ((2, 130, 24, 128), (2, 130, 8, 128),
                             (2, 130, 8, 128)))
    fa_ops.reset_launches()
    o = fa_ops.flash_attention(q, k, v, causal=True)
    assert o.requires_grad
    do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
    o.backward(do)
    assert fa_ops.LAUNCHES == {"flash_attn": 1, "flash_attn_bwd": 1}
    _, lse = fa_kernel.flash_attn(q.detach(), k.detach(), v.detach(),
                                  causal=True, window=None, logit_cap=None,
                                  kv_len=None, with_lse=True)
    want = fa_kernel.flash_attn_bwd(q.detach(), k.detach(), v.detach(),
                                    o.detach(), do, lse, causal=True,
                                    window=None, logit_cap=None)
    for t, w in zip((q, k, v), want):
        assert t.grad is not None and torch.equal(t.grad, w)
    o = fa_ops.flash_attention(q, k, v, causal=True, kv_len=100)
    with pytest.raises(NotImplementedError, match="kv_len"):
        o.sum().backward()


@pytest.mark.cuda
def test_flash_attention_asks_lse_only_for_gradients(monkeypatch):
    """B5 writes the rows' log-sum-exp only where a backward will read it:
    a call under no_grad, or on inputs that need no gradient, launches B5
    with no lse and builds no graph; a call that needs a gradient asks for
    it.  O's bits are the same on both routes."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops

    asked = []
    launch = fa_kernel.flash_attn

    def spy(*args, with_lse=False, **kw):
        asked.append(with_lse)
        return launch(*args, with_lse=with_lse, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attn", spy)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(torch.bfloat16)
               for shape in ((1, 200, 24, 128), (1, 200, 8, 128),
                             (1, 200, 8, 128)))
    fa_ops.reset_launches()
    served = fa_ops.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        fa_ops.flash_attention(q.requires_grad_(), k, v, causal=True)
    trained = fa_ops.flash_attention(q, k, v, causal=True)
    assert asked == [False, False, True]
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
    assert fa_ops.LAUNCHES == {"flash_attn": 3, "flash_attn_bwd": 0}


def _rel_l2_cuda(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D,S", [(2, 64, 32, 8), (1, 517, 200, 16),
                                     (2, 130, 77, 64)])
def test_mamba_gradients_flow_on_card(B, L, D, S, dtype):
    """Under autograd on CUDA tensors, B6 and B7 train: `mamba_chunk_scan`
    goes through MambaChunkScan (B6, then B6-bwd, bitwise its plain
    version) and `fused_mamba_scan` through MambaFusedScan (B7 with tile
    checkpoints, then B7-bwd: each gradient in its input's type, within
    relative L2 1e-5 of the plain backward where returned in f32, 1e-2 in
    bf16)."""
    _need_cuda()
    from repro_torch.kernels.mamba_scan.ref import scan_ref_bwd

    dt, xc, b, c, a_mat, h0 = _fused_inputs(B, L, D, S, dtype)
    leaves = [t.clone().requires_grad_() for t in (dt, xc, b, c, a_mat, h0)]
    g = torch.Generator(device="cuda").manual_seed(11)
    gy = torch.randn((B, L, D), generator=g, device="cuda")
    ghl = torch.randn((B, D, S), generator=g, device="cuda")
    ms_ops.reset_launches()
    y, hl = ms_fused.fused_mamba_scan(*leaves[:5], h0=leaves[5])
    got = torch.autograd.grad((y, hl), leaves, (gy, ghl))
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 1,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 1,
                               "mamba_ssd_bwd": 0}
    want = ms_fused.fused_mamba_scan_plain_bwd(dt, xc, b, c, a_mat, h0, gy,
                                               ghl)
    for x, w, leaf in zip(got, want, leaves):
        assert x.dtype == leaf.dtype and x.shape == leaf.shape
        bound = 1e-2 if x.dtype == torch.bfloat16 else 1e-5
        assert _rel_l2_cuda(x, w) <= bound
    a = (0.5 + 0.499 * torch.rand((B, L, D, S), generator=g,
                                  device="cuda")).requires_grad_()
    bb = (0.1 * torch.randn((B, L, D, S), generator=g,
                            device="cuda")).requires_grad_()
    h = h0.clone().requires_grad_()
    ms_ops.reset_launches()
    hs, hl = ms_ops.mamba_chunk_scan(a, bb, h, chunk=L, block_d=D)
    g_hs = torch.randn(hs.shape, generator=g, device="cuda")
    got = torch.autograd.grad((hs, hl), (a, bb, h), (g_hs, ghl))
    assert ms_ops.LAUNCHES == {"mamba_scan": 1, "mamba_fused": 0,
                               "mamba_scan_bwd": 1, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}
    want = scan_ref_bwd(a.detach(), hs.detach(), h0, g_hs, ghl)
    for x, w in zip(got, want):
        assert torch.equal(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_fused_same_bits_with_checkpoints(dtype):
    """B7's y and h_last are the same bits with its tile checkpoints
    written and without, and the checkpoints are the states at the tile
    starts (the first one h0)."""
    _need_cuda()
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel

    dt, xc, b, c, a_mat, h0 = _fused_inputs(2, 517, 1000, 16, dtype)
    y0, hl0 = ms_kernel.mamba_fused(dt, xc, b, c, a_mat, h0)
    y1, hl1, ckpt = ms_kernel.mamba_fused(dt, xc, b, c, a_mat, h0,
                                          checkpoints=True)
    tile = ms_kernel.fused_config()["tile"]
    assert ckpt.shape == (2, -(-517 // tile), 1000, 16)
    assert torch.equal(y0, y1) and torch.equal(hl0, hl1)
    assert torch.equal(ckpt[:, 0], h0)
    _, hl_tile = ms_kernel.mamba_fused(dt[:, :tile].contiguous(),
                                       xc[:, :tile].contiguous(),
                                       b[:, :tile].contiguous(),
                                       c[:, :tile].contiguous(), a_mat, h0)
    assert torch.equal(ckpt[:, 1], hl_tile)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 64])
def test_mamba_bwd_kernels_are_deterministic(S):
    """Two calls of B7-bwd (its sums over D and over the batch in a fixed
    order, no atomics) and of B6-bwd give the same bits; so does the
    mamba2 path's gradient through `ssd_channels` (autograd sums each
    head's channels back into the head)."""
    _need_cuda()
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.models import mamba as tmamba

    dt, xc, b, c, a_mat, h0 = _fused_inputs(3, 300, 2048, S, torch.bfloat16)
    _, _, ckpt = ms_kernel.mamba_fused(dt, xc, b, c, a_mat, h0,
                                       checkpoints=True)
    g = torch.Generator(device="cuda").manual_seed(13)
    gy = torch.randn(dt.shape, generator=g, device="cuda")
    runs = [ms_kernel.mamba_fused_bwd(dt, xc, b, c, a_mat, ckpt, gy, None)
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    a = 0.5 + 0.499 * torch.rand((2, 64, 256, S), generator=g, device="cuda")
    h = h0[:2, :256].contiguous()
    hs, _ = ms_kernel.mamba_scan(a, a, h)
    runs = [ms_kernel.mamba_scan_bwd(a, hs, h, hs, None) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    nh, hd = 8, 64
    dth = 0.001 + 0.099 * torch.rand((2, 200, nh), generator=g, device="cuda")
    xh = torch.randn((2, 200, nh, hd), generator=g, device="cuda")
    bm, cm = (torch.randn((2, 200, 64), generator=g, device="cuda")
              for _ in range(2))
    a_h = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
    hz = torch.zeros((2, nh, hd, 64), device="cuda")
    gz = torch.randn((2, 200, nh, hd), generator=g, device="cuda")

    def grads():
        leaves = [t.clone().requires_grad_() for t in (dth, xh, bm, cm, a_h)]
        y, _ = tmamba.fused_chunked_scan_m2(*leaves, hz, 256)
        return torch.autograd.grad(y, leaves, gz)

    assert all(torch.equal(x, y) for x, y in zip(grads(), grads()))


def _ssd_inputs_cuda(B, L, nh, hd, S, dtype, seed=17):
    """The SSD scan's inputs (zamba2's a_h = -(1 .. nh)) on the card."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def cu(x):
        return torch.from_numpy(np.ascontiguousarray(x.astype(f))).cuda()

    dt = cu(rng.uniform(0.001, 0.1, (B, L, nh)))
    xh, b, c = (cu(rng.normal(size=sh)).to(dtype)
                for sh in ((B, L, nh, hd), (B, L, S), (B, L, S)))
    a_h = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
    h0 = cu(rng.normal(size=(B, nh, hd, S)))
    return dt, xh, b, c, a_h, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form,B,L,width,S", [
    # per channel: (B, L, D, S); L ragged against the 64-step tiles and the
    # 8-step sub-tiles, D against the block's channels and the cluster of 8
    ("channel", 2, 77, 200, 8), ("channel", 1, 130, 1000, 16),
    ("channel", 3, 5, 40, 16), ("channel", 2, 70, 77, 64),
    ("channel", 1, 131, 2064, 64),
    # mamba2: (B, L, (nh, hd), S); hd 4 (four heads a chunk of q and r),
    # 32 (two chunks a head) and zamba2's 64
    ("ssd", 2, 77, (3, 4), 8), ("ssd", 1, 100, (5, 32), 16),
    ("ssd", 2, 67, (9, 64), 64), ("ssd", 1, 1, (2, 64), 64),
])
def test_mamba_bwd_forms_match_plain_on_card(form, B, L, width, S, dtype):
    """B7-bwd's two forms against their plain versions: each gradient within
    relative L2 1e-5 where returned in f32 and 1e-2 in bf16, two calls
    bitwise equal, one launch counted a call."""
    _need_cuda()
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel

    g = torch.Generator(device="cuda").manual_seed(23)
    if form == "channel":
        dt, xc, b, c, a_mat, h0 = _fused_inputs(B, L, width, S, dtype)
        _, _, ckpt = ms_kernel.mamba_fused(dt, xc, b, c, a_mat, h0,
                                           checkpoints=True)
        gy = torch.randn(dt.shape, generator=g, device="cuda")
        ghl = torch.randn(h0.shape, generator=g, device="cuda")
        args = (dt, xc, b, c, a_mat, ckpt, gy, ghl)
        run, key = ms_kernel.mamba_fused_bwd, "mamba_fused_bwd"
        want = ms_fused.fused_mamba_scan_plain_bwd(dt, xc, b, c, a_mat, h0,
                                                   gy, ghl)
        leaves = (dt, xc, b, c, a_mat, h0)
    else:
        nh, hd = width
        dt, xh, b, c, a_h, h0 = _ssd_inputs_cuda(B, L, nh, hd, S, dtype)
        dt_d, xc, a_mat, h0_d = ms_fused.ssd_channels(dt, xh, a_h, h0)
        _, _, ckpt = ms_kernel.mamba_fused(dt_d, xc, b, c,
                                           a_mat.contiguous(), h0_d,
                                           checkpoints=True)
        gy = torch.randn(xh.shape, generator=g, device="cuda")
        ghl = torch.randn(h0.shape, generator=g, device="cuda")
        args = (dt, xh, b, c, a_h, ckpt, gy, ghl)
        run, key = ms_kernel.mamba_ssd_bwd, "mamba_ssd_bwd"
        want = ms_fused.fused_ssd_scan_plain_bwd(dt, xh, b, c, a_h, h0, gy,
                                                 ghl)
        leaves = (dt, xh, b, c, a_h, h0)
    ms_ops.reset_launches()
    got, again = run(*args), run(*args)
    assert ms_ops.LAUNCHES[key] == 2
    assert sum(ms_ops.LAUNCHES.values()) == 2
    for x, y, w, leaf in zip(got, again, want, leaves):
        assert x.dtype == leaf.dtype and x.shape == leaf.shape
        assert torch.equal(x, y)
        bound = 1e-2 if x.dtype == torch.bfloat16 else 1e-5
        assert _rel_l2_cuda(x, w) <= bound


@pytest.mark.cuda
def test_mamba2_layer_under_grad_launches_the_mamba2_form():
    """A mamba2 mixer under grad on the card: its scan is one B7 launch
    (with checkpoints) and its backward one launch of B7-bwd's mamba2 form,
    never the per-channel form; the gradients reach every parameter."""
    _need_cuda()
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.models import mamba as tmamba

    cfg = dataclasses.replace(configs.get("zamba2-2.7b"), d_model=256,
                              ssm_head_dim=64)   # d_inner 512: 8 heads
    p = tmamba.make_mamba2(torch.Generator(device="cuda").manual_seed(3),
                           cfg, torch.bfloat16)
    for t in p.values():
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.requires_grad_()
    x = torch.randn((2, 100, cfg.d_model), device="cuda").to(torch.bfloat16)
    ms_ops.reset_launches()
    y = tmamba.apply_mamba2(p, x, cfg)
    y.float().square().mean().backward()
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 1,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 1}
    for name in ("in_proj", "a_log", "dt_bias", "out_proj"):
        assert p[name].grad is not None
        assert bool(torch.isfinite(p[name].grad).all()), name


@pytest.mark.cuda
def test_mamba_fused_asks_checkpoints_only_for_gradients(monkeypatch):
    """B7 writes its tile checkpoints only where a backward will read
    them: a call under no_grad, or on inputs that need no gradient,
    launches B7 with none and builds no graph; a call that needs a
    gradient asks for them.  y's bits are the same on both routes."""
    _need_cuda()
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel

    asked = []
    launch = ms_kernel.mamba_fused

    def spy(*args, checkpoints=False):
        asked.append(checkpoints)
        return launch(*args, checkpoints=checkpoints)

    monkeypatch.setattr(ms_kernel, "mamba_fused", spy)
    dt, xc, b, c, a_mat, h0 = _fused_inputs(1, 100, 64, 16, torch.bfloat16)
    ms_ops.reset_launches()
    served, _ = ms_fused.fused_mamba_scan(dt, xc, b, c, a_mat, h0=h0)
    with torch.no_grad():
        ms_fused.fused_mamba_scan(dt.requires_grad_(), xc, b, c, a_mat,
                                  h0=h0)
    trained, _ = ms_fused.fused_mamba_scan(dt, xc, b, c, a_mat, h0=h0)
    assert asked == [False, False, True]
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 3,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}


@pytest.mark.cuda
def test_train_gradients_on_card_match_cpu():
    """The loss and every gradient leaf of a narrow llama on the card (B5,
    B5-bwd, bf16 cuBLAS, remat "full") against the same parameters and
    batch on the CPU (plain attention, f32 products): loss within 1e-2
    relative, each leaf within relative L2 2e-2 (bf16 products against
    f32 ones, through two layers and the tied unembedding); 2 B5 launches
    a layer (forward and remat recompute) and one B5-bwd call a layer."""
    _need_cuda()
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch._util import map_tree
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(configs.smoke("llama3.2-3b"), d_model=256,
                              n_heads=4, n_kv_heads=2, head_dim=64,
                              d_ff=512)
    params = lm.make_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = synthetic.make_dataset(cfg, 64, 2, device="cuda").batch(0)
    loss_fn = step_lib.make_loss_fn(cfg)
    fa_ops.reset_launches()
    m, grads = step_lib.value_and_grad(loss_fn, params, batch)
    assert fa_ops.LAUNCHES == {"flash_attn": 2 * cfg.n_layers,
                               "flash_attn_bwd": cfg.n_layers}
    mc, gc = step_lib.value_and_grad(
        loss_fn, map_tree(lambda t: t.cpu(), params),
        {k: v.cpu() for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(mc["loss"])) <= 1e-2 * float(
        mc["loss"])
    for (path, a), (_, b) in zip(_leaves(grads), _leaves(gc)):
        assert a.dtype == b.dtype and _rel_l2(a.cpu(), b) <= 2e-2, path


@pytest.mark.cuda
def test_train_launcher_runs_on_its_defaults():
    """`python -m repro_torch.launch.train` without arguments on the card:
    the smoke config with its heads widened for B5, losses finite; each
    step launches B5 and B5-bwd."""
    _need_cuda()
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.launch import train as launch_train

    fa_ops.reset_launches()
    res = launch_train.main(["--steps", "3"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert fa_ops.LAUNCHES["flash_attn_bwd"] > 0


def _leaves(tree):
    from repro_torch._util import tree_leaves

    return list(tree_leaves(tree))


def _scan_inputs(b, L, d, s):
    """B6's inputs as the JAX kernel test draws them, on the card."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 0.999, (b, L, d, s)).astype(np.float32)
    bb = (rng.normal(size=(b, L, d, s)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(b, d, s)).astype(np.float32)
    return (torch.from_numpy(x).cuda() for x in (a, bb, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,d,s,chunk,bd", [
    (2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 32, 32), (2, 32, 16, 4, 32, 16),
    (1, 64, 128, 8, 64, 64), (1, 2048, 512, 16, 256, 256)])
def test_mamba_scan_kernel_matches_plain(b, L, d, s, chunk, bd):
    """B6 bitwise its plain version (every operation rounded once, in the
    same order)."""
    _need_cuda()
    a, bb, h0 = _scan_inputs(b, L, d, s)
    ms_ops.reset_launches()
    hs, hl = ms_ops.mamba_chunk_scan(a, bb, h0, chunk=chunk, block_d=bd)
    assert ms_ops.LAUNCHES == {"mamba_scan": 1, "mamba_fused": 0,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}
    hs_p, hl_p = scan_ref(a, bb, h0)
    assert torch.equal(hs, hs_p) and torch.equal(hl, hl_p)


def _fused_inputs(B, L, D, S, dtype):
    """B7's inputs as the JAX kernel test draws them, on the card."""
    rng = np.random.default_rng(7)
    dt, xc, b, c = (torch.from_numpy(x.astype(np.float32)).cuda() for x in (
        rng.uniform(0.001, 0.1, (B, L, D)), rng.normal(size=(B, L, D)),
        rng.normal(size=(B, L, S)), rng.normal(size=(B, L, S))))
    a_mat = -torch.exp(0.3 * torch.from_numpy(
        rng.normal(size=(D, S)).astype(np.float32))).cuda()
    xc, b, c = (x.to(dtype) for x in (xc, b, c))
    h0 = torch.from_numpy(rng.normal(size=(B, D, S)).astype(np.float32))
    return dt, xc, b, c, a_mat, h0.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,S", [
    (2, 64, 32, 8), (1, 128, 64, 16), (1, 517, 1000, 16), (3, 5, 40, 8),
    # ragged against the ring stage (32 steps), U (4 steps) and the block's
    # channels (64 at S = 16, 128 at S = 8)
    (1, 1, 72, 16), (1, 65, 8200, 16), (2, 300, 4104, 8),
    # D % 4 != 0: the narrow (one element) copies
    (1, 37, 1001, 16),
    # S = 64 (mamba2): zamba2's d_inner, D ragged against the block's 16
    # channels, and narrow copies
    (1, 517, 5120, 64), (2, 70, 1000, 64), (1, 37, 1001, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_fused_kernel_matches_plain(B, L, D, S, dtype):
    """B7 within atol/rtol 1e-5 of its plain version, from zero and from a
    nonzero h0, at any L and D.  The two sum y over the states in the same
    order and round every other operation once; expf (the kernel) and
    torch.exp on the card are what could still part them."""
    _need_cuda()
    dt, xc, b, c, a_mat, h0 = _fused_inputs(B, L, D, S, dtype)
    ms_ops.reset_launches()
    for start in (None, h0):
        y, hl = ms_fused.fused_mamba_scan(dt, xc, b, c, a_mat, h0=start)
        y_p, hl_p = ms_fused.fused_mamba_scan_plain(dt, xc, b, c, a_mat,
                                                    start)
        torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(hl, hl_p, atol=1e-5, rtol=1e-5)
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 2,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_fused_narrow_copies_equal_wide(dtype):
    """Rows that start off a 4-element boundary (a view one element into
    its storage, D % 4 == 0) take the narrow copies: the same kernel, the
    same bits as the aligned copy of the same inputs."""
    _need_cuda()
    B, L, D, S = 1, 70, 4104, 16
    ins = _fused_inputs(B, L, D, S, dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    dt, xc, b, c = (shifted(t) for t in ins[:4])
    assert dt.is_contiguous() and dt.data_ptr() % 16 != 0
    ms_ops.reset_launches()
    y_w, hl_w = ms_fused.fused_mamba_scan(*ins[:5], h0=ins[5])
    y_n, hl_n = ms_fused.fused_mamba_scan(dt, xc, b, c, ins[4], h0=ins[5])
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 2,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}
    assert torch.equal(y_w, y_n) and torch.equal(hl_w, hl_n)
    y_p, hl_p = ms_fused.fused_mamba_scan_plain(*ins)
    torch.testing.assert_close(y_n, y_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl_n, hl_p, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_mamba_fused_counts_one_launch_per_call():
    """LAUNCHES["mamba_fused"] adds one for each call that launches and
    nothing for an empty one; empty inputs give zeros or a copy of h0."""
    _need_cuda()
    dt, xc, b, c, a_mat, h0 = _fused_inputs(2, 9, 40, 8, torch.bfloat16)
    ms_ops.reset_launches()
    for n in range(1, 4):
        ms_fused.fused_mamba_scan(dt, xc, b, c, a_mat, h0=h0 if n % 2 else
                                  None)
        assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": n,
                                   "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                                   "mamba_ssd_bwd": 0}
    for cut in (dict(L=0), dict(B=0)):
        L, B = cut.get("L", 9), cut.get("B", 2)
        e_dt, e_xc, e_b, e_c = (t[:B, :L].contiguous() for t in (dt, xc, b, c))
        for start in (None, h0[:B]):
            y, hl = ms_fused.fused_mamba_scan(e_dt, e_xc, e_b, e_c, a_mat,
                                              h0=start)
            assert y.shape == (B, L, 40) and y.dtype == torch.float32
            want = torch.zeros((B, 40, 8), device="cuda") if start is None \
                else start
            assert torch.equal(hl, want)
            assert want.numel() == 0 or hl.data_ptr() != want.data_ptr()
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 3,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}


@pytest.mark.cuda
def test_mamba_kernels_launch_nothing_on_empty_inputs():
    _need_cuda()
    ms_ops.reset_launches()
    a = torch.zeros((0, 8, 16, 4), device="cuda")
    hs, _ = ms_ops.mamba_chunk_scan(a, a, torch.zeros((0, 16, 4),
                                                      device="cuda"))
    dt = torch.zeros((1, 0, 32), device="cuda")
    e = torch.zeros((1, 0, 8), device="cuda")
    h0 = torch.ones((1, 32, 8), device="cuda")
    y, hl = ms_fused.fused_mamba_scan(dt, dt, e, e,
                                      torch.zeros((32, 8), device="cuda"),
                                      h0=h0)
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 0,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}
    assert hs.shape == a.shape and y.shape == (1, 0, 32)
    assert torch.equal(hl, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_scan_is_one_b7_launch(dtype):
    """`fused_chunked_scan_m2` on the card: one B7 launch at any L, within
    1e-5 of B7's plain version on the same expanded inputs and of the
    chunked body on the CPU."""
    _need_cuda()
    from repro_torch.models import mamba as tmamba

    rng = np.random.default_rng(9)
    B, L, nh, hd, ds = 1, 300, 12, 64, 64
    dt = torch.from_numpy(rng.uniform(0.001, 0.5, (B, L, nh)).astype(
        np.float32))
    xh, b, c = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        dtype) for sh in ((B, L, nh, hd), (B, L, ds), (B, L, ds)))
    a_h = -torch.arange(1.0, nh + 1)
    h0 = torch.from_numpy(rng.normal(size=(B, nh, hd, ds)).astype(np.float32))
    cpu = (dt, xh, b, c, a_h, h0)
    ms_ops.reset_launches()
    y, hl = tmamba.fused_chunked_scan_m2(*(t.cuda() for t in cpu), 256)
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 1,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}
    assert y.shape == (B, L, nh, hd) and hl.shape == (B, nh, hd, ds)
    dt_d, xc, a_mat, h0_d = tmamba.ssd_channels(dt.cuda(), xh.cuda(),
                                                a_h.cuda(), h0.cuda())
    y_p, hl_p = ms_fused.fused_mamba_scan_plain(dt_d, xc, b.cuda(), c.cuda(),
                                                a_mat, h0_d)
    torch.testing.assert_close(y.flatten(2), y_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl.flatten(1, 2), hl_p, atol=1e-5, rtol=1e-5)
    y_c, hl_c = tmamba.fused_chunked_scan_m2(*cpu, 256)
    torch.testing.assert_close(y.cpu(), y_c, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hl.cpu(), hl_c, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_hybrid_forward_launches_b7_per_layer_and_b5_per_super_block():
    """A small zamba2 (head dim 64, which B5 takes) through lm.forward and
    prefill on the card: one B7 launch a mamba2 layer and one B5 launch an
    application of the shared block; logits within relative L2 1e-2 of
    the CPU run of the same parameters."""
    _need_cuda()
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.smoke("zamba2-2.7b"), d_model=128,
                              n_heads=2, n_kv_heads=2, head_dim=64)
    params = lm.make_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    cpu_params = _to_cpu(params)
    toks = torch.randint(0, cfg.vocab_size, (1, 37),
                         generator=torch.Generator().manual_seed(1))
    ms_ops.reset_launches()
    fa_ops.reset_launches()
    out = lm.forward(params, toks.cuda(), cfg, return_caches=True,
                     cache_len=64)
    assert ms_ops.LAUNCHES == {"mamba_scan": 0, "mamba_fused": 2 * 4,
                               "mamba_scan_bwd": 0, "mamba_fused_bwd": 0,
                               "mamba_ssd_bwd": 0}
    assert fa_ops.LAUNCHES == {"flash_attn": 2 * 2, "flash_attn_bwd": 0}
    want = lm.forward(cpu_params, toks, cfg, return_caches=True, cache_len=64)
    a, b = out.logits.double().cpu(), want.logits.double()
    assert float((a - b).norm() / b.norm()) <= 1e-2
    assert out.caches.shared_kv.k.shape == (2, 1, 64, 2, 64)
    lg, _ = lm.decode_step(params, toks[:, :1].cuda(), out.caches, cfg)
    assert lg.shape == (1, 1, cfg.vocab_size) and bool(
        torch.isfinite(lg).all())


def _to_cpu(tree):
    """A parameter tree's copy on the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def _moe_cfg(arch):
    """A narrow MoE decoder of ``arch``'s kind (head dim 64, which B5
    takes; 8 or 16 experts)."""
    import dataclasses

    import repro_torch.configs as configs

    return dataclasses.replace(
        configs.smoke(arch), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, n_experts=8 if arch == "grok-1-314b" else 16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_layer_on_card_matches_cpu(arch):
    """`apply_moe` on the card (bf16 cuBLAS expert products, index
    dispatch on device tensors) against the same weights on the CPU on one
    input: the routes equal (the router is f32 on both, TF32 off), the
    aux within 1e-5, the output within relative L2 1e-2."""
    _need_cuda()
    from repro_torch.models import moe

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _moe_cfg(arch)
    p = moe.make_moe(torch.Generator(device="cuda").manual_seed(0), cfg,
                     torch.bfloat16)
    cpu_p = _to_cpu(p)
    x = torch.randn((2, 150, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    out, aux = moe.apply_moe(p, x.cuda(), cfg)
    want, want_aux = moe.apply_moe(cpu_p, x, cfg)
    cap = moe._capacity(300, cfg)
    r = moe._route(p, x.cuda()[None].flatten(1, 2), cfg, cap)[0]
    w = moe._route(cpu_p, x[None].flatten(1, 2), cfg, cap)[0]
    for a, b in zip(r[1:], w[1:]):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)
        else:
            assert torch.equal(a.cpu(), b)
    for a, b in zip(aux, want_aux):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)
    a, b = out.double().cpu(), want.double()
    assert out.dtype == torch.bfloat16
    assert float((a - b).norm() / b.norm()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_forward_launches_b5_per_layer(arch):
    """A narrow MoE decoder through lm.forward and prefill on the card: one
    B5 launch a layer each; finite logits, the expert load summing to k;
    decode steps finite."""
    _need_cuda()
    import dataclasses

    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(_moe_cfg(arch), n_layers=4)
    params = lm.make_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 37),
                         generator=torch.Generator().manual_seed(1)).cuda()
    fa_ops.reset_launches()
    out = lm.forward(params, toks, cfg, return_caches=True, cache_len=64)
    assert fa_ops.LAUNCHES == {"flash_attn": 2 * 4, "flash_attn_bwd": 0}
    assert bool(torch.isfinite(out.logits).all())
    n_moe = sum(k == "moe" for k in lm.layer_pattern(cfg)[0])
    assert abs(float(out.aux.expert_load.sum())
               - n_moe * cfg.n_experts_active) < 1e-5
    st = out.caches
    for t in range(3):
        lg, st = lm.decode_step(params, toks[:, t:t + 1], st, cfg)
        assert lg.shape == (1, 1, cfg.vocab_size)
        assert bool(torch.isfinite(lg).all())
    assert st.caches[0].length.tolist() == [[40]] * len(st.caches[0].length)
