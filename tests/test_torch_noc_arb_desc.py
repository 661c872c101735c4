"""B1's strided operands: the dense inputs `router.router_cycle` hands its
arbitration function, and the descriptor through which the CUDA kernel
reads them in place.

* The port's `arbitrate_lanes` (its CPU route) against the JAX
  `arbitrate_lanes` (the Pallas kernel in interpret mode), bitwise, on the
  very operands `router_cycle` passes: (S, R, .) tensors with bool and
  int32 elements and expanded views (zero strides).
* A CPU transcription of the kernel's addressing.  The descriptor words are
  built by `ops.lanes_desc` / `ops.rows_desc`, exactly as the wrappers build
  them on the card; each lane's operands are gathered through the words'
  pointers, element types and strides with plain torch indexing (the
  kernel's loads), `fused.lane_arbitrate` runs on the gathered rows, its
  results are scattered through the output words (the kernel's stores),
  and the outputs must equal `router.arbitrate` bitwise.  Both layouts:
  dense (S, R, .) with broadcast, expanded, transposed, int8, uint8, int16
  and int64 operands, and (rows, L) lane rows.  The kernel cannot run here;
  this is the test that catches a stride bug before the card does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_router import _random_subnet_state

from repro.core.noc import router as jrt
from repro.kernels.noc_cycle import ops as jops
from repro_torch import interop
from repro_torch.core.noc import router as trt
from repro_torch.core.noc.topology import make_topology as tmake_topology
from repro_torch.kernels.noc_cycle import fused, kernel, ops

P, V, B = 5, 4, 4
PV = P * V


def router_cycle_operands(seed, faults: bool):
    """The 11 operands (and depth) `router_cycle` passes its arbitration
    function for one cycle of a random dense state."""
    rng = np.random.default_rng(seed)
    S, R = 4, 36
    state = interop.subnet_state(_random_subnet_state(rng, S, R))
    kw = {}
    if faults:
        kw = dict(link_ok=torch.from_numpy(rng.random((R, P)) < 0.9),
                  router_ok=torch.from_numpy(rng.random(R) < 0.9))
    seen = []

    def record(*args, depth):
        seen.append((args, depth))
        return trt.arbitrate(*args, depth=depth)

    trt.router_cycle(
        state, *trt.device_tables(tmake_topology())[:3],
        torch.from_numpy(rng.random((S, V)) < 0.7),
        torch.from_numpy(rng.random((S, V)) < 0.7),
        torch.tensor(int(rng.integers(-1, 2)), dtype=torch.int32),
        torch.from_numpy(rng.random((S, R)) < 0.8),
        torch.from_numpy(np.asarray([True, True, False, True])),
        arbitrate_fn=record, **kw,
    )
    (args, depth), = seen
    return args, depth


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(
        np.asarray(a).astype(np.int64),
        torch.as_tensor(b).numpy().astype(np.int64), err_msg=msg)


@pytest.mark.parametrize("seed,faults", [(0, False), (1, True), (2, True)])
def test_arbitrate_lanes_matches_jax_on_router_cycle_operands(seed, faults):
    args, depth = router_cycle_operands(seed, faults)
    # the operands are the dense engine's: broadcast views among them
    assert args[5].stride()[0] == 0 and args[6].shape[1] == 1
    assert args[8].stride() == (0, 0)
    j = jops.arbitrate_lanes(*(jnp.asarray(a.numpy()) for a in args),
                             depth=depth)
    ops.reset_launches()
    t = ops.arbitrate_lanes(*args, depth=depth)
    assert ops.LAUNCHES["noc_arbitrate"] == 0      # CPU: the plain version
    ref = trt.arbitrate(*args, depth=depth)
    for name, a, b, c in zip(jrt.Arbitration._fields, j, t, ref):
        assert b.dtype == c.dtype and b.shape == c.shape, name
        _eq(a, b, name)


# ---------------------------------------------------------------------------
# the kernel's addressing, transcribed
# ---------------------------------------------------------------------------

def _storage(t: torch.Tensor, ptr: int) -> tuple[torch.Tensor, int]:
    """The whole storage under ``t`` as a 1-D tensor of its dtype, and the
    element index of ``ptr`` in it."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    base, rem = divmod(ptr - t.untyped_storage().data_ptr(), t.element_size())
    assert rem == 0 and 0 <= base < flat.numel()
    return flat, base


def _offsets(words, k, lane_idx, n_i, n_j):
    """(n_i * n_j, lanes) element offsets of operand k, row i * n_j + j."""
    op = words[kernel.D_HEADER + k * kernel.D_OPERAND:][:kernel.D_OPERAND]
    lane_st, a, b = op[2:2 + kernel.ARB_LEAD], op[-2], op[-1]
    lane_off = sum(ix * s for ix, s in zip(lane_idx, lane_st))
    i = torch.arange(n_i)[:, None, None]
    j = torch.arange(n_j)[None, :, None]
    return (lane_off[None, None] + i * a + j * b).reshape(n_i * n_j, -1), op


def gather(words, k, t, n_i, n_j, lane_idx) -> torch.Tensor:
    """Operand k's values as the kernel loads them: (n_i * n_j, lanes)
    int32 rows (an int64 element keeps its low 32 bits)."""
    off, op = _offsets(words, k, lane_idx, n_i, n_j)
    assert op[1] == kernel.ARB_TYPES[t.dtype]
    flat, base = _storage(t, op[0])
    return flat[base + off].to(torch.int32)


def scatter(words, k, t, rows: torch.Tensor, lane_idx) -> None:
    """Write (n, lanes) rows through output k's words (the kernel's
    stores)."""
    off, op = _offsets(words, k, lane_idx, rows.shape[0], 1)
    assert op[1] == kernel.ARB_TYPES[t.dtype]
    flat, base = _storage(t, op[0])
    flat[base + off] = rows.to(t.dtype)


def transcribe(words, ins, outs):
    """Run one B1 launch on the CPU as the kernel addresses its operands."""
    lanes, depth, v = words[:3]
    size = words[3:kernel.D_HEADER]
    lane = torch.arange(lanes)
    lane_idx = []
    for n in reversed(size):
        lane_idx.insert(0, lane % n)
        lane = lane // n
    o = fused.N_PORTS
    dims = [(PV, 1)] * 3 + [(o, 1), (o, v), (o, 1), (v, 1), (v, 1)] + \
        [(1, 1)] * 3
    rows = [gather(words, k, t, n_i, n_j, lane_idx)
            for k, (t, (n_i, n_j)) in enumerate(zip(ins, dims))]
    va, cl, op, rr, dn, ex, gm, cm, sa, acc, act = rows
    arb = fused.lane_arbitrate(va != 0, cl, op, rr, dn, ex != 0, gm != 0,
                               cm != 0, sa, acc != 0, act != 0, depth=depth)
    for k, (t, r) in enumerate(zip(outs, arb)):
        scatter(words, kernel.ARB_IN + k, t, r.to(torch.int32), lane_idx)


def _variants(args):
    """The router_cycle operands, and the same values in other dtypes and
    strides the wrapper must take: int8 / uint8 / int16 / int64 elements,
    a transposed (non-contiguous) down_count, an expanded mask and sa_pref
    as a 0-d tensor that broadcasts to every lane."""
    va, cl, op, rr, dn, ex, gm, cm, sa, acc, act = args
    S, R = va.shape[:2]
    dn_t = dn.to(torch.int8).transpose(0, 1).contiguous().transpose(0, 1)
    yield "router_cycle", args
    yield "mixed dtypes and strides", (
        va.to(torch.uint8), cl.to(torch.int8), op.to(torch.int64),
        rr.to(torch.int16), dn_t, ex.to(torch.int32), gm.expand(S, R, V),
        cm, sa[0, 0], acc.to(torch.int8), act.to(torch.uint8))


@pytest.mark.parametrize("seed,faults", [(3, False), (4, True)])
def test_dense_descriptor_transcription_equals_router_arbitrate(seed,
                                                                faults):
    args, depth = router_cycle_operands(seed, faults)
    ref = trt.arbitrate(*args, depth=depth)
    for label, ins in _variants(args):
        arb, words = ops.lanes_desc(ins, depth=depth)
        assert words[:kernel.D_HEADER] == [4 * 36, depth, V, 1, 1, 4, 36]
        for t in arb:                    # poison: every output is written
            t.fill_(True if t.dtype == torch.bool else -7)
        transcribe(words, ins, arb)
        for name, a, b in zip(jrt.Arbitration._fields, arb, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            _eq(b, a, f"{label}: {name}")


@pytest.mark.parametrize("seed", [5, 6])
def test_rows_descriptor_transcription_equals_router_arbitrate(seed):
    """(rows, L) lane rows, as B2's layout and chip_smoke's phase 2 hold
    them (here non-contiguous transposes of the dense operands, some int8),
    through `ops.rows_desc`."""
    args, depth = router_cycle_operands(seed, True)
    ref = trt.arbitrate(*args, depth=depth)
    lead = tuple(args[0].shape[:-1])
    lanes = lead[0] * lead[1]
    tails = ((PV,), (PV,), (PV,), (P,), (P, V), (P,), (V,), (V,), (), (),
             ())

    def rows(x, tail):
        n = int(np.prod(tail))
        return torch.broadcast_to(x, lead + tail).reshape(lanes, n).T

    ins = [rows(x, t) for x, t in zip(args, tails)]
    ins[3], ins[4] = ins[3].to(torch.int8), ins[4].to(torch.int8)
    assert not ins[1].is_contiguous()
    arb, words = ops.rows_desc(tuple(ins), depth=depth)
    assert words[:kernel.D_HEADER] == [lanes, depth, V, 1, 1, 1, lanes]
    transcribe(words, ins, arb)
    plain = ops.arbitrate_rows(*ins, depth=depth)
    for name, a, b, c in zip(fused.LaneArb._fields, arb, plain, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _eq(b, a, name)
        _eq(c.reshape(lanes, -1).T, a, name)


def test_descriptor_refuses_what_the_kernel_cannot_read():
    args, depth = router_cycle_operands(7, False)
    bad = list(args)
    bad[1] = bad[1].to(torch.float32)
    with pytest.raises(ValueError, match="operand 1"):
        ops.lanes_desc(tuple(bad), depth=depth)
    bad = list(args)
    bad[4] = bad[4][..., :2]                      # V = 2: not instantiated
    bad[0], bad[1], bad[2] = (x[..., :10] for x in args[:3])
    bad[6], bad[7] = args[6][..., :2], args[7][..., :2]
    with pytest.raises(ValueError, match="V=2"):
        ops.lanes_desc(tuple(bad), depth=depth)
    bad = list(args)
    bad[3] = bad[3][:, :7]                        # does not broadcast
    with pytest.raises(ValueError, match="broadcast"):
        ops.lanes_desc(tuple(bad), depth=depth)
    five = tuple(x[None, None, None] for x in args)
    with pytest.raises(ValueError, match="lane dims"):
        ops.lanes_desc(five, depth=depth)
