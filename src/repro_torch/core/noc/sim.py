"""Cycle-stepped heterogeneous-chiplet NoC simulation with the KF in the loop.

  traffic sources -> routers (VC alloc + switch alloc) -> MCs -> replies
        ^                                                          |
        '------ per-epoch counters -> Kalman Filter -> policy <----'

Modes (paper §4.2): ``baseline`` (shared VCs, RR arbitration), ``fair``
(static 2:2 VC split), ``static`` (fixed [g : V-g] split), ``4subnet``
(class-segregated subnets, half link width) and ``kf`` (KF-driven 2:2 <->
3:1 VC split plus GPU,GPU,CPU arbitration under warmup/hold/revert
hysteresis).  Every mode runs on a subnet axis padded to ``S_MAX``.

One run is a Python loop over epochs.  Each epoch:

* set-up: the epoch's VC masks, SA preference stream and node classes from
  the applied configuration, the epoch prologue inject, and the epoch's
  random streams (u_phase (L,), u_gen (L, R), d_idx (L, R));
* ``epoch_len`` cycles on one of three engines, which agree bitwise:
  ``"fused"`` (default) hands the whole epoch to one launch of the fused
  cycle kernel on the lane state; ``"ref"`` runs the dense torch cycle
  body; ``"arb"`` runs the dense body with the arbitration kernel;
* the epoch boundary on the host CPU: normalize the counters, step the
  predictor bank and KF, binarize, apply the hysteresis policy.

`simulate_with_trace` runs the same loop with the flight recorder on and
returns a `SimTrace` beside the `SimResult`: the fabric probes accumulate
per cycle (the fused engine then launches the probed cycle kernel), and
the KF internals, the observation, the fault count and the node-class plan
are kept per epoch.  The switch is a Python flag, so `simulate` runs none
of it, and the `SimResult` of a traced run is bitwise the untraced one.

The data plane runs on the run's device; the control plane (a scalar KF
and a three-integer state machine) runs on the CPU, once per epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._util import resolve_device, stack_trees, tree_map
from repro_torch.core import kalman, predictor, threefry
from repro_torch.core.allocator import (
    ModePolicy,
    PolicyConfig,
    apply_policy_gated,
    class_vc_masks,
    degrade_policy,
    epoch_sa_prefs,
    init_policy_state,
    mode_policy,
    placement_class,
)
from repro_torch.core.noc import metrics
from repro_torch.core.noc import router as rt
from repro_torch.core.noc.faults import (
    TELEM_DROP,
    TELEM_NAN,
    TELEM_SPIKE,
    FaultSourceLike,
    FaultStream,
    resolve_faults,
)
from repro_torch.core.noc.placement import (
    PlacementSourceLike,
    PlacementStream,
    resolve_placement,
)
from repro_torch.core.noc.topology import Topology, make_topology
from repro_torch.core.noc.traffic import (
    TrafficSource,
    TrafficSourceLike,
    WorkloadProfile,
    init_phase,
    injection_rates,
    resolve_source,
    stack_profiles,
    step_phase_u,
)
from repro_torch.obs.probes import SimTrace

Tensor = torch.Tensor
_I32 = torch.int32

BCAP = 64   # per-node source-queue capacity
S_MAX = 4   # padded subnet-axis length shared by every mode
ENGINES = ("fused", "ref", "arb")

# epoch-stream provider: epoch -> (u_phase (L,), u_gen (L, R), d_idx (L, R)),
# or (B, L), (B, L, R), (B, L, R) for a batch of B runs
EpochStreams = Callable[[int], tuple[Tensor, Tensor, Tensor]]


@dataclasses.dataclass(frozen=True)
class SimStatic:
    """The structural part of a simulation config."""

    n_subnets: int
    n_vcs: int
    buf_depth: int
    epoch_len: int
    n_epochs: int
    mc_queue_cap: int
    mc_service_period: int
    mshr_limit: int
    policy: PolicyConfig
    z_scales: tuple[float, float, float]
    kf_q: float
    kf_r: float
    engine: str = "fused"
    width: int = 6
    height: int = 6
    n_mc: int = 8


@dataclasses.dataclass(frozen=True)
class NoCConfig:
    mode: str = "kf"              # baseline | fair | 4subnet | kf | static
    static_gpu_vcs: int = 2       # for mode=static: GPU gets [g : V-g]
    n_vcs: int = 4
    buf_depth: int = 4
    epoch_len: int = 500
    n_epochs: int = 120
    mc_queue_cap: int = 16
    mc_service_period: int = 2
    mshr_limit: int = 16
    policy: PolicyConfig = PolicyConfig()
    z_scales: tuple[float, float, float] = (300.0, 160.0, 2500.0)
    kf_q: float = 1e-3
    kf_r: float = 2e-1
    seed: int = 0
    engine: str = "fused"         # cycle engine: fused | ref | arb
    predictor: str = "kf"
    ema_alpha: float = 0.5
    guard: bool = False
    faults: FaultSourceLike = None
    placement: PlacementSourceLike = None
    control: str = "bandwidth"
    width: int = 6
    height: int = 6
    n_mc: int = 8

    @property
    def vcs_per_subnet(self) -> int:
        return self.n_vcs // 2 if self.mode == "4subnet" else self.n_vcs

    def static_spec(self) -> SimStatic:
        """The structural spec; every mode shares the S_MAX-padded one."""
        return SimStatic(
            n_subnets=S_MAX,
            n_vcs=self.n_vcs,
            buf_depth=self.buf_depth,
            epoch_len=self.epoch_len,
            n_epochs=self.n_epochs,
            mc_queue_cap=self.mc_queue_cap,
            mc_service_period=self.mc_service_period,
            mshr_limit=self.mshr_limit,
            policy=self.policy,
            z_scales=tuple(self.z_scales),
            kf_q=self.kf_q,
            kf_r=self.kf_r,
            engine=self.engine,
            width=self.width,
            height=self.height,
            n_mc=self.n_mc,
        )

    def mode_policy(self) -> ModePolicy:
        stc = self.static_spec()
        return mode_policy(
            self.mode, stc.n_vcs, self.static_gpu_vcs,
            n_subnets=stc.n_subnets, active_vcs=self.vcs_per_subnet,
            predictor=self.predictor, ema_alpha=self.ema_alpha,
            guard=self.guard, control=self.control,
        )


class MCState(NamedTuple):
    q_meta: Tensor       # (R, Q) int8 — pending request src | cls << 6
    head: Tensor         # (R,) int32
    count: Tensor        # (R,) int32
    timer: Tensor        # (R,) int32 cycles until service completes
    stage_valid: Tensor  # (R,) bool staged reply waiting to inject
    stage_dst: Tensor    # (R,) int32
    stage_cls: Tensor    # (R,) int32


class EpochCounters(NamedTuple):
    gpu_push: Tensor
    gpu_stall_icnt: Tensor
    gpu_stall_dram: Tensor
    cpu_push: Tensor
    gpu_done: Tensor
    cpu_done: Tensor
    gpu_gen: Tensor
    cpu_gen: Tensor
    lat_sum: Tensor
    lat_cnt: Tensor
    cpu_lat_sum: Tensor
    cpu_lat_cnt: Tensor
    gpu_lat_sum: Tensor
    gpu_lat_cnt: Tensor
    moved: Tensor


class _ProbeAcc(NamedTuple):
    """Dense-engine flight-recorder accumulators over one epoch; the fused
    engine's twin is `fused.ProbeLanes`.  Both sample END-of-cycle state."""

    occ: Tensor      # (S, R, P, V) int32 summed VC occupancy
    grant: Tensor    # (S, R) int32 switch grants, summed over outputs
    deny: Tensor     # (S, R) int32 refused requests, summed over outputs
    mcq_sum: Tensor  # (R,) int32 summed MC queue depth
    mcq_max: Tensor  # (R,) int32 running max MC queue depth


def _zero_probe_acc(S: int, R: int, V: int, device) -> _ProbeAcc:
    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    return _ProbeAcc(occ=z(S, R, rt.N_PORTS, V), grant=z(S, R),
                     deny=z(S, R), mcq_sum=z(R), mcq_max=z(R))


class SimResult(NamedTuple):
    gpu_ipc: Tensor         # (E,) per-epoch GPU IPC proxy
    cpu_ipc: Tensor         # (E,)
    avg_latency: Tensor     # (E,) mean packet network latency
    kf_signal: Tensor       # (E,) binarized predictor output
    applied_config: Tensor  # (E,) configuration applied at the epoch's end
    counters: EpochCounters  # (E,) leaves
    gpu_inj_rate: Tensor    # (E,) offered GPU load
    gpu_vc_quota: Tensor    # (E,) VCs the GPU class could use this epoch


def stamp_mask(stc: SimStatic) -> int:
    """0xFFFF when every age of the run fits 16 bits (total cycles <= 2^16):
    latency ages are then masked as uint16 stamps would wrap them (the
    reference's "auto" stamp dtype); 0 (no mask) for longer runs."""
    return 0xFFFF if stc.epoch_len * stc.n_epochs <= 2**16 else 0


def init_sim_state(stc: SimStatic, device: torch.device | str = "cpu",
                   n_rows: int | None = None):
    """Zero carry: (subnets, MC state, outstanding, backlog); with
    ``n_rows`` every leaf has that leading batch dim."""
    R = make_topology(stc.width, stc.height, stc.n_mc).n_routers
    S, V, B, P = stc.n_subnets, stc.n_vcs, stc.buf_depth, rt.N_PORTS
    lead = () if n_rows is None else (n_rows,)

    def z(shape, dtype=_I32):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    subnets0 = rt.SubnetState(
        buf_meta=z((S, R, P, V, B), torch.int16),
        buf_binj=z((S, R, P, V, B)),
        head=z((S, R, P, V), torch.int8),
        count=z((S, R, P, V), torch.int8),
        rr_ptr=z((S, R, P), torch.int8),
    )
    mc0 = MCState(
        q_meta=z((R, stc.mc_queue_cap), torch.int8),
        head=z((R,)), count=z((R,)), timer=z((R,)),
        stage_valid=z((R,), torch.bool), stage_dst=z((R,)), stage_cls=z((R,)),
    )
    return subnets0, mc0, z((R,)), z((R,))


def torch_epoch_streams(
    gen: torch.Generator, epoch_len: int, n_routers: int, n_mc: int,
    device: torch.device,
) -> EpochStreams:
    """Per-epoch streams of one run drawn from ``gen`` on ``device``, in
    epoch order: u_phase ~ U[0,1) (L,), u_gen ~ U[0,1) (L, R), d_idx ~
    U{0..n_mc-1} (L, R)."""

    def draw(epoch: int):
        u_phase = torch.rand((epoch_len,), generator=gen, device=device)
        u_gen = torch.rand((epoch_len, n_routers), generator=gen,
                           device=device)
        d_idx = torch.randint(0, n_mc, (epoch_len, n_routers),
                              generator=gen, device=device)
        return u_phase, u_gen, d_idx

    return draw


# the int64 temporaries of one chunk of threefry draws stay under this
STREAM_BYTES = 1 << 30


def threefry_epoch_streams(
    seeds: Sequence[int], n_epochs: int, epoch_len: int, n_routers: int,
    n_mc: int, device: torch.device | str = "cpu",
) -> EpochStreams:
    """The reference simulator's random streams for a batch of seeds, bit
    for bit, from JAX's threefry (`repro_torch.core.threefry`) under the
    partitionable setting in force when this is called.

    As the reference draws them: the epoch keys are split(PRNGKey(seed),
    n_epochs); an epoch's key splits into epoch_len cycle keys, each split
    in three: u_phase = uniform(k0, ()), u_gen = uniform(k1, (R,)), d_idx =
    randint(k2, (R,), 0, n_mc).  Returns epoch -> (u_phase (B, L), u_gen
    (B, L, R) float32, d_idx (B, L, R) int32) on ``device``.  Rows with one
    seed share one draw.  Epochs are drawn vectorized, in chunks whose
    int64 temporaries stay under STREAM_BYTES: a paper run of one seed is
    one chunk, drawn at its first epoch."""
    flag = threefry.partitionable()
    uniq, inv = torch.unique(torch.as_tensor(list(seeds), dtype=torch.int64),
                             return_inverse=True)
    # distinct seeds in ascending order (one run among them) need no gather
    inv = None if inv.equal(torch.arange(len(inv))) else inv.to(device)
    keys = threefry.split(threefry.prng_key(uniq, device), n_epochs)
    # ~12 int64 words alive per drawn element at the widest step
    per_epoch = len(uniq) * epoch_len * n_routers * 8 * 12
    chunk = max(1, min(n_epochs, STREAM_BYTES // per_epoch))
    drawn: dict[int, tuple] = {}

    def draw(lo: int):
        with threefry.threefry_partitionable(flag):
            k3 = threefry.split(
                threefry.split(keys[:, lo:lo + chunk], epoch_len), 3)
            return (threefry.uniform(k3[..., 0, :]),
                    threefry.uniform(k3[..., 1, :], (n_routers,)),
                    threefry.randint(k3[..., 2, :], (n_routers,), 0, n_mc))

    def streams(epoch: int):
        lo = epoch - epoch % chunk
        if lo not in drawn:
            drawn.clear()
            drawn[lo] = draw(lo)
        return tuple(x[:, epoch - lo] if inv is None else x[:, epoch - lo][inv]
                     for x in drawn[lo])

    return streams


def _batched_streams(streams: EpochStreams) -> EpochStreams:
    """A provider that gives one run's (L,) / (L, R) streams, given the
    leading batch dim of one."""
    def draw(epoch: int):
        u_phase, u_gen, d_idx = streams(epoch)
        if u_phase.ndim == 1:
            return u_phase[None], u_gen[None], d_idx[None]
        return u_phase, u_gen, d_idx

    return draw


class RunInputs(NamedTuple):
    """A batch of B runs' resolved inputs, every row on one `SimStatic`.
    Each leaf has the leading B.  Demand rows and fault masks live on the
    run's device; telemetry faults and placement plans on the CPU."""

    stc: SimStatic
    mp: ModePolicy                # (B, ...) leaves
    topo: Topology
    profile: WorkloadProfile      # (B, E) float32 leaves
    faults: FaultStream
    placement: PlacementStream
    streams: EpochStreams         # epoch -> (B, L), (B, L, R), (B, L, R)
    device: torch.device

    @property
    def n_rows(self) -> int:
        return int(self.mp.four_subnet.shape[0])


def _per_row(cfgs: list, sources, seeds) -> tuple[list, list]:
    """Per-row sources (one source broadcasts) and seeds (default: each
    config's own), checked against the number of configs."""
    n = len(cfgs)
    # a WorkloadProfile is itself a tuple: one source is told by its type
    if isinstance(sources, (str, TrafficSource)):
        sources = [sources] * n
    sources = list(sources)
    seeds = [c.seed for c in cfgs] if seeds is None else [int(x) for x in seeds]
    if len(sources) != n or len(seeds) != n:
        raise ValueError(f"{len(sources)} sources and {len(seeds)} seeds for "
                         f"{n} configs")
    return sources, seeds


def batch_inputs(
    cfgs: Sequence[NoCConfig],
    sources: TrafficSourceLike | Sequence,
    *,
    seeds: Sequence[int] | None = None,
    device: str | torch.device | None = None,
    rng: torch.Generator | EpochStreams | None = None,
    engine: str | None = None,
) -> RunInputs:
    """Resolve B configurations (one `static_spec()`), their sources (one
    for all rows, or one per row) and seeds (default: each config's own)
    into one `RunInputs`.  ``rng`` None draws the reference's threefry
    streams; a `torch.Generator` drives a batch of one; a provider gives
    (B, ...) streams, or one run's (L,) / (L, R) streams for a batch of
    one."""
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("a batch needs at least one config")
    stc = cfgs[0].static_spec()
    for c in cfgs[1:]:
        if c.static_spec() != stc:
            raise ValueError(
                "all configs in a batch must share the same structural "
                f"config; got {c.static_spec()} != {stc}; group with sweep()")
    if engine is not None:
        stc = dataclasses.replace(stc, engine=engine)
    if stc.engine not in ENGINES:
        raise ValueError(f"unknown cycle engine {stc.engine!r}; expected one "
                         f"of {ENGINES}")
    sources, seeds = _per_row(cfgs, sources, seeds)
    dev = resolve_device(device)
    topo = make_topology(stc.width, stc.height, stc.n_mc)
    if rng is None:
        streams = threefry_epoch_streams(
            seeds, stc.n_epochs, stc.epoch_len, topo.n_routers,
            len(topo.mc_ids), dev)
    elif isinstance(rng, torch.Generator):
        if len(cfgs) != 1:
            raise ValueError("a torch.Generator drives a batch of one run")
        streams = _batched_streams(torch_epoch_streams(
            rng, stc.epoch_len, topo.n_routers, len(topo.mc_ids), dev))
    else:
        streams = _batched_streams(rng)
    profile = stack_profiles(resolve_source(x, stc.n_epochs) for x in sources)
    # the neighbor table makes a materialized link fault two-way
    faults = stack_trees([
        resolve_faults(c.faults, stc.n_epochs, n_routers=topo.n_routers,
                       neighbor=topo.neighbor, opposite=topo.opposite)
        for c in cfgs])
    return RunInputs(
        stc=stc, mp=stack_trees([c.mode_policy() for c in cfgs]), topo=topo,
        profile=WorkloadProfile(*(x.to(dev) for x in profile)),
        faults=faults._replace(
            link_ok=faults.link_ok.to(dev), router_ok=faults.router_ok.to(dev),
            mc_ok=faults.mc_ok.to(dev),
        ),
        placement=stack_trees([
            resolve_placement(c.placement, stc.n_epochs, topo) for c in cfgs]),
        streams=streams, device=dev,
    )


def run_inputs(
    cfg: NoCConfig,
    source: TrafficSourceLike,
    *,
    device: str | torch.device | None = None,
    rng: torch.Generator | EpochStreams | None = None,
    engine: str | None = None,
) -> RunInputs:
    """Resolve `simulate`'s arguments (see there): a batch of one."""
    return batch_inputs([cfg], source, device=device, rng=rng, engine=engine)


class EpochInputs(NamedTuple):
    """Per-epoch data-plane inputs of a batch, shared by every cycle
    engine.  Each leaf has the batch's leading B but ``cycles`` and
    ``rep_gate``, which every row shares."""

    gpu_masks: Tensor   # (B, S, V) bool
    cpu_masks: Tensor
    place_cls: Tensor   # (B, R) int32 node-class plan of the applied config
    ntype_e: Tensor     # (B, R) int32 virtual node type (MC tiles 2)
    node_cls: Tensor    # (B, R) int32
    req_sub: Tensor     # (B, R) int32
    prof: WorkloadProfile  # (B,) float32 leaves
    link_ok: Tensor     # (B, R, P) bool
    router_ok: Tensor   # (B, R) bool
    mc_ok: Tensor       # (B, R) bool
    cycles: Tensor      # (L,) int32
    u_phase: Tensor     # (B, L) float32
    u_gen: Tensor       # (B, L, R) float32
    dests: Tensor       # (B, L, R) int32
    sa_all: Tensor      # (B, L) int32
    active_all: Tensor  # (B, L, S) bool
    rep_gate: Tensor    # (L,) bool
    gpu_quota: Tensor   # (B,) int32 on the CPU: VCs the GPU class may use


_SHARED = ("cycles", "rep_gate")


def _epoch_row(ep: EpochInputs, b: int) -> EpochInputs:
    """Row ``b`` of a batch's `EpochInputs`: one run's, no leading dim."""
    return EpochInputs(*(
        x if f in _SHARED else tree_map(lambda t: t[b], x)
        for f, x in zip(EpochInputs._fields, ep)
    ))


def epoch_inputs(
    run: RunInputs, e: int, config: Tensor, cycle0: int
) -> EpochInputs:
    """Epoch ``e``'s inputs under the applied ``config`` ((B,) int32 on the
    CPU, or one value for every row) with its cycles starting at
    ``cycle0``; draws the epoch's random streams."""
    stc, mp, topo, dev = run.stc, run.mp, run.topo, run.device
    S, V, ep_len = stc.n_subnets, stc.n_vcs, stc.epoch_len
    n = run.n_rows
    config = torch.as_tensor(config, dtype=_I32).expand(n)
    g_vec, c_vec = class_vc_masks(mp, config)                   # (B, V)
    cls_e = placement_class(mp, config, run.placement.cls0[:, e],
                            run.placement.cls1[:, e])            # (B, R)
    is_mc = torch.as_tensor(topo.node_type) == 2
    ntype_e = torch.where(is_mc, 2, cls_e).to(_I32).to(dev)
    node_cls = (ntype_e == 1).to(_I32)
    fs = mp.four_subnet.to(dev)
    sub_enabled = mp.sub_enabled.to(dev)
    sub_ids = torch.arange(S, dtype=_I32, device=dev)
    mc_ids = torch.as_tensor(topo.mc_ids, dtype=torch.int64, device=dev)

    u_phase, u_gen, d_idx = run.streams(e)
    cycles_cpu = cycle0 + torch.arange(ep_len, dtype=_I32)
    cycles = cycles_cpu.to(dev)
    alternating = (cycles[:, None] % 2) == (sub_ids[None, :] % 2)
    return EpochInputs(
        gpu_masks=g_vec.to(dev)[:, None, :].expand(n, S, V),
        cpu_masks=c_vec.to(dev)[:, None, :].expand(n, S, V),
        place_cls=cls_e.to(_I32), ntype_e=ntype_e, node_cls=node_cls,
        req_sub=torch.where(fs[:, None], 2 * node_cls, 0).to(_I32),
        prof=WorkloadProfile(*(leaf[:, e] for leaf in run.profile)),
        link_ok=run.faults.link_ok[:, e], router_ok=run.faults.router_ok[:, e],
        mc_ok=run.faults.mc_ok[:, e], cycles=cycles,
        u_phase=u_phase.to(dev), u_gen=u_gen.to(dev),
        dests=mc_ids[d_idx.to(dev).long()].to(_I32),
        sa_all=epoch_sa_prefs(mp, config, cycles_cpu).to(dev),
        active_all=sub_enabled[:, None, :]
        & torch.where(fs[:, None, None], alternating, True),
        rep_gate=torch.arange(ep_len, device=dev) < ep_len - 1,
        gpu_quota=g_vec.to(_I32).sum(-1).to(_I32),
    )


def lane_tables(run: RunInputs):
    """The fused engine's run constants: its `LaneDims`, and the route and
    link-exists lane tables."""
    from repro_torch.kernels.noc_cycle import fused as lanes

    stc, topo = run.stc, run.topo
    d = lanes.lane_dims(
        S=stc.n_subnets, R=topo.n_routers, V=stc.n_vcs, B=stc.buf_depth,
        Q=stc.mc_queue_cap, width=topo.width,
        mc_service_period=stc.mc_service_period, mshr_limit=stc.mshr_limit,
        bcap=BCAP, stamp_mask=stamp_mask(stc),
    )
    route_rows, exists_rows, _ = lanes.run_consts(d, topo, run.device)
    return d, route_rows, exists_rows


def lane_inputs(run: RunInputs, tables, ep: EpochInputs):
    """One epoch's inputs to `ops.fused_cycle_step` for the whole batch in
    the lane layout: per-cycle ``xi`` (B, L, XI_ROWS, S*64) / ``xf`` (B, L,
    XF_ROWS, 128) and the epoch-constant rows (gmask, cmask, prof, pol_sr,
    pol_r, ntype, route, exists), each with the leading B but ``route``,
    which every row shares; link faults folded into ``exists`` and
    router/MC faults into ``xi``."""
    from repro_torch.kernels.noc_cycle import fused as lanes

    d, route_rows, exists_rows = tables
    mp, dev = run.mp, run.device
    fs = mp.four_subnet.to(dev)
    sub_enabled = mp.sub_enabled.to(dev)
    sub_is_req = mp.sub_is_req.to(dev)
    sub_ids = torch.arange(d.S, dtype=_I32, device=dev)
    gm_rows, cm_rows = lanes.mask_rows(d, ep.gpu_masks[:, 0],
                                       ep.cpu_masks[:, 0])
    req_match = ((sub_ids[:, None] == ep.req_sub[:, None, :])
                 & sub_enabled[:, :, None])
    pol_sr, pol_r = lanes.policy_rows(
        d, sub_enabled, sub_is_req, sub_enabled & ~sub_is_req, req_match, fs,
        sub_is_req.to(_I32).sum(-1).to(_I32),
    )
    xi, xf = lanes.cycle_xs(
        d, ep.cycles, ep.u_phase, ep.u_gen, ep.dests, ep.sa_all,
        ep.active_all, ep.rep_gate, router_ok=ep.router_ok, mc_ok=ep.mc_ok,
    )
    link_rows = torch.nn.functional.pad(
        ep.link_ok.to(_I32).transpose(-1, -2), (0, lanes.R_PAD - d.R)
    ).repeat(1, 1, d.S)
    consts = (gm_rows, cm_rows, lanes.prof_rows(ep.prof), pol_sr, pol_r,
              lanes.placement_rows(d, ep.ntype_e), route_rows,
              exists_rows * link_rows)
    return xi, xf, consts


def lane_row(xi: Tensor, xf: Tensor, consts, b: int):
    """Row ``b`` of a batch's `lane_inputs`: one simulation's kernel
    inputs ((L, XI_ROWS, S*64), ...), ``route`` as it is."""
    return xi[b], xf[b], tuple(c if c.ndim == 2 else c[b] for c in consts)


class _RowPolicy(NamedTuple):
    """One row's subnet structure on the run's device (the dense cycle)."""

    fs: Tensor           # () bool
    sub_enabled: Tensor  # (S,) bool
    sub_is_req: Tensor   # (S,) bool
    sub_is_rep: Tensor   # (S,) bool
    n_req_subs: Tensor   # () int32


def _simulate_impl(run: RunInputs, probe: bool = False):
    """The epoch loop over a batch of B rows; returns a `SimResult` whose
    leaves have the leading B, and with ``probe`` (B = 1) also the
    `SimTrace`.  On the "fused" engine an epoch is one kernel launch for
    the whole batch and the epoch boundary one pass over all rows (one
    device->host copy of the counters); the dense engines walk the rows."""
    stc, mp, topo, dev = run.stc, run.mp, run.topo, run.device
    n = run.n_rows
    if probe and n != 1:
        raise ValueError("the flight recorder takes a batch of one run")
    route_t, nb_t, opp_t, _, _ = rt.device_tables(topo, dev)
    R, S, Q = topo.n_routers, stc.n_subnets, stc.mc_queue_cap
    ep_len = stc.epoch_len
    smask = stamp_mask(stc)

    is_mc_cpu = torch.as_tensor(topo.node_type) == 2
    is_mc = is_mc_cpu.to(dev)
    ar = torch.arange(R, dtype=_I32, device=dev)
    fs = mp.four_subnet.to(dev)
    sub_enabled = mp.sub_enabled.to(dev)
    sub_is_req = mp.sub_is_req.to(dev)
    sub_ids = torch.arange(S, dtype=_I32, device=dev)

    subs, mc, outst, backlog = init_sim_state(stc, dev, n_rows=n)
    phase = init_phase().to(dev).expand(n).clone()
    policy = tree_map(lambda x: x.expand(n).clone(), init_policy_state())
    pred_state = tree_map(lambda x: x.expand(n, *x.shape).clone(),
                          predictor.init_state())
    kf_params = kalman.paper_params(q=stc.kf_q, r=stc.kf_r)
    z_scales = torch.tensor(stc.z_scales, dtype=torch.float32)

    if stc.engine == "fused":
        from repro_torch.kernels.noc_cycle import fused as lanes
        from repro_torch.kernels.noc_cycle import ops as lane_ops

        tables = lane_tables(run)
        d = tables[0]
    else:
        rows_pol = [_RowPolicy(
            fs=fs[b], sub_enabled=sub_enabled[b], sub_is_req=sub_is_req[b],
            sub_is_rep=sub_enabled[b] & ~sub_is_req[b],
            n_req_subs=sub_is_req[b].to(_I32).sum().to(_I32),
        ) for b in range(n)]
    arb_fn = rt.arbitrate
    if stc.engine == "arb":
        from repro_torch.kernels.noc_cycle.ops import arbitrate_lanes as arb_fn

    def want_rep(mc, fs, sub_enabled):
        """(..., S, R): the staged MC replies' inject requests, on the
        reply subnet of their class."""
        rep_target = torch.where(fs[..., None], 2 * mc.stage_cls + 1, 1)
        return (
            (sub_ids[:, None] == rep_target[..., None, :])
            & (mc.stage_valid & is_mc)[..., None, :]
            & sub_enabled[..., :, None]
        )

    def dense_cycle(ep: EpochInputs, pol: _RowPolicy, i: int, carry):
        subs, mc, phase, outstanding, bl_count, cnt = carry[:6]
        cycle = ep.cycles[i]
        is_req_row = pol.sub_is_req[:, None]

        # MC acceptance (queue depth BEFORE this cycle's service)
        can_accept = torch.where(is_mc, mc.count <= Q - pol.n_req_subs, True)
        accept_s = torch.where(is_req_row, can_accept[None, :], True)

        # 1. MC service (a stalled MC freezes timer and staging)
        can_serve = is_mc & (mc.count > 0) & ~mc.stage_valid & ep.mc_ok
        timer = torch.where(can_serve, torch.clamp(mc.timer - 1, min=0),
                            mc.timer)
        done = can_serve & (timer == 0)
        q_head = torch.gather(mc.q_meta, 1, mc.head.long()[:, None])[:, 0]
        q_head = q_head.to(_I32)
        src_out = q_head & ((1 << rt.META_SRC_SHIFT) - 1)
        cls_out = q_head >> rt.META_SRC_SHIFT
        mc = mc._replace(
            head=torch.where(done, (mc.head + 1) % Q, mc.head),
            count=mc.count - done.to(_I32),
            timer=torch.where(done, stc.mc_service_period, timer),
            stage_valid=mc.stage_valid | done,
            stage_dst=torch.where(done, src_out, mc.stage_dst),
            stage_cls=torch.where(done, cls_out, mc.stage_cls),
        )

        # 2. route/arbitrate every subnet
        subs, ev = rt.router_cycle(
            subs, route_t, nb_t, opp_t, ep.gpu_masks, ep.cpu_masks,
            ep.sa_all[i], accept_s, ep.active_all[i], arbitrate_fn=arb_fn,
            link_ok=ep.link_ok, router_ok=ep.router_ok,
        )

        # 3. request ejections at MCs -> MC queues; an exclusive prefix over
        # subnets serializes same-MC arrivals into consecutive slots
        req_ej = ev.eject_valid & is_req_row & is_mc[None, :]
        arr_i = req_ej.to(_I32)
        slot_off = torch.cumsum(arr_i, 0).to(_I32) - arr_i
        slot = (mc.head[None, :] + mc.count[None, :] + slot_off) % Q
        qmask = req_ej[..., None] & (
            slot[..., None] == torch.arange(Q, device=dev)
        )
        qhit = qmask.any(0)
        q_val = ev.eject_src + (ev.eject_cls << rt.META_SRC_SHIFT)
        qm = torch.where(qmask, q_val[..., None], 0).sum(0)
        mc = mc._replace(
            q_meta=torch.where(qhit, qm.to(torch.int8), mc.q_meta),
            count=mc.count + arr_i.sum(0).to(_I32),
        )
        # reply ejections at source nodes -> completed transactions
        rep_ej = ev.eject_valid & pol.sub_is_rep[:, None] & (~is_mc)[None, :]
        rep_done = rep_ej.any(0)
        outstanding = outstanding - rep_done.to(_I32)
        rep_cls = torch.where(rep_ej, ev.eject_cls, 0).sum(0)

        # network latency (16-bit wraparound when the stamps would be uint16)
        age = cycle - ev.eject_binj
        if smask:
            age = age & smask
        ej_lat = torch.where(ev.eject_valid, age, 0)
        cpu_ej = ev.eject_valid & (ev.eject_cls == 0)
        gpu_ej = ev.eject_valid & (ev.eject_cls == 1)

        # 4. source generation -> per-node source-queue depth
        phase = step_phase_u(ep.prof, phase, ep.u_phase[i])
        rates = injection_rates(ep.prof, ep.ntype_e, phase)
        gen = (ep.u_gen[i] < rates) & ~is_mc
        bl_count = bl_count + (gen & (bl_count < BCAP)).to(_I32)
        can_inj = (bl_count > 0) & (outstanding < stc.mshr_limit) & ~is_mc

        # 5. ONE merged inject: sources (request rows) + staged replies
        want_src = (
            (sub_ids[:, None] == ep.req_sub[None, :])
            & can_inj[None, :] & pol.sub_enabled[:, None]
        )
        want = want_rep(mc, pol.fs, pol.sub_enabled) & ep.rep_gate[i]
        subs, ok = rt.inject_all(
            subs, want_src | want,
            torch.where(is_req_row, ep.dests[i][None, :], mc.stage_dst[None, :]),
            ar.expand(S, R),
            torch.where(is_req_row, ep.node_cls[None, :], mc.stage_cls[None, :]),
            torch.where(is_req_row, cycle, cycle + 1),
            ep.gpu_masks, ep.cpu_masks,
        )
        inj_ok = (ok & is_req_row).any(0)
        mc = mc._replace(
            stage_valid=mc.stage_valid & ~(ok & ~is_req_row).any(0)
        )
        bl_count = bl_count - inj_ok.to(_I32)
        outstanding = outstanding + inj_ok.to(_I32)

        # 6. counters
        is_gpu = ep.ntype_e == 1
        is_cpu = ep.ntype_e == 0
        inc = torch.stack([
            (inj_ok & is_gpu).sum(),
            (is_gpu & (bl_count > 0)).sum(),
            ev.dram_block_gpu,
            (inj_ok & is_cpu).sum(),
            (rep_done & (rep_cls == 1)).sum(),
            (rep_done & (rep_cls == 0)).sum(),
            (gen & is_gpu).sum(),
            (gen & is_cpu).sum(),
            ej_lat.sum(),
            ev.eject_valid.sum(),
            torch.where(cpu_ej, ej_lat, 0).sum(),
            cpu_ej.sum(),
            torch.where(gpu_ej, ej_lat, 0).sum(),
            gpu_ej.sum(),
            ev.moved,
        ]).to(_I32)
        out = (subs, mc, phase, outstanding, bl_count, cnt + inc)
        if not probe:
            return out
        # 7. flight recorder: END-of-cycle state (the fused engine samples
        # at the same point)
        prb = carry[6]
        return out + (_ProbeAcc(
            occ=prb.occ + subs.count.to(_I32),
            grant=prb.grant + ev.grant_cnt,
            deny=prb.deny + ev.deny_cnt,
            mcq_sum=prb.mcq_sum + mc.count,
            mcq_max=torch.maximum(prb.mcq_max, mc.count),
        ),)

    outs, probes = [], []
    cycle0 = 0
    for e in range(stc.n_epochs):
        # ---- epoch set-up: masks, node classes, streams, prologue inject
        ep = epoch_inputs(run, e, policy.config, cycle0)

        # replies staged on the previous epoch's last cycle inject under
        # THIS epoch's masks (the in-cycle inject is gated off on the last
        # cycle of an epoch by rep_gate)
        subs, ok0 = rt.inject_all(
            subs, want_rep(mc, fs, sub_enabled), mc.stage_dst[:, None, :], ar,
            mc.stage_cls[:, None, :], ep.cycles[0], ep.gpu_masks,
            ep.cpu_masks,
        )
        mc = mc._replace(stage_valid=mc.stage_valid & ~ok0.any(-2))

        # ---- the epoch's cycles
        if stc.engine == "fused":
            xi, xf, consts = lane_inputs(run, tables, ep)
            ls0 = lanes.pack_state(d, subs, mc, outst, backlog, phase)
            if probe:
                ls, pb = lane_ops.fused_cycle_step(
                    d, ls0, xi, xf, *consts,
                    probe=lanes.zero_probe(d, dev, (n,)), donate=True,
                )
                prb = _ProbeAcc(*lanes.unpack_probe(d, pb))
            else:
                ls = lane_ops.fused_cycle_step(d, ls0, xi, xf, *consts,
                                               donate=True)
            subs, mc, outst, backlog, phase = lanes.unpack_state(d, ls, MCState)
            cnt = ls.cnt[:, 0, :lanes.N_COUNTERS]
        else:
            carries = []
            for b in range(n):
                carry = tuple(tree_map(lambda x: x[b], part) for part in
                              (subs, mc, phase, outst, backlog))
                carry += (torch.zeros(15, dtype=_I32, device=dev),)
                if probe:
                    carry += (_zero_probe_acc(S, R, stc.n_vcs, dev),)
                ep_b = _epoch_row(ep, b)
                for i in range(ep_len):
                    carry = dense_cycle(ep_b, rows_pol[b], i, carry)
                carries.append(carry)
            subs, mc, phase, outst, backlog, cnt = (
                stack_trees(x) for x in list(zip(*carries))[:6])
            if probe:
                prb = stack_trees([c[6] for c in carries])
        cycle0 += ep_len
        # one device->host copy of the batch's counters an epoch
        cnt = EpochCounters(*cnt.cpu().unbind(-1))

        # ---- epoch boundary on the host, all rows at once: KF +
        # predictor bank + policy
        raw = torch.stack([
            cnt.gpu_stall_dram.float(), cnt.gpu_push.float(),
            cnt.gpu_stall_icnt.float(),
        ], dim=-1)
        z = kalman.normalize_observations(
            raw, torch.zeros(3, dtype=torch.float32), z_scales
        )
        tm = run.faults.telem_mode[:, e, None]
        z = torch.where(tm == TELEM_DROP, -1.0, z)
        z = torch.where(tm == TELEM_SPIKE, z + run.faults.telem_mag[:, e, None],
                        z)
        z = torch.where(tm == TELEM_NAN, float("nan"), z)
        pred_state, signal, kfi = predictor.step_probed(
            mp.predictor, kf_params, pred_state, z
        )
        if probe:
            probes.append(tuple(tree_map(lambda x: x[0], part)
                                for part in (prb, kfi, z, ep.place_cls)))
        cyc = torch.tensor(cycle0, dtype=_I32)
        policy = apply_policy_gated(stc.policy, mp, policy, signal, cyc)
        policy = degrade_policy(policy, pred_state.healthy)

        gpu_ipc = metrics.gpu_ipc_proxy(cnt.gpu_done.float(),
                                        cnt.gpu_gen.float())
        cpu_lat = cnt.cpu_lat_sum / torch.clamp(cnt.cpu_lat_cnt, min=1)
        avg_lat = cnt.lat_sum / torch.clamp(cnt.lat_cnt, min=1)
        n_gpu = ((ep.place_cls == 1) & ~is_mc_cpu).sum(-1)
        inj_rate = cnt.gpu_push.float() / (ep_len * n_gpu)
        outs.append((
            gpu_ipc, metrics.cpu_ipc_proxy(cpu_lat), avg_lat, signal,
            policy.config, cnt, inj_rate, ep.gpu_quota,
        ))

    def over_epochs(xs):
        return torch.stack(xs, dim=-1)

    gpu_ipc, cpu_ipc, avg_lat, sig, conf, cnts, inj, quota = zip(*outs)
    result = SimResult(
        gpu_ipc=over_epochs(gpu_ipc).float(),
        cpu_ipc=over_epochs(cpu_ipc).float(),
        avg_latency=over_epochs(avg_lat).float(),
        kf_signal=over_epochs(sig),
        applied_config=over_epochs(conf),
        counters=EpochCounters(*(over_epochs(x) for x in zip(*cnts))),
        gpu_inj_rate=over_epochs(inj).float(),
        gpu_vc_quota=over_epochs(quota),
    )
    if not probe:
        return result
    return result, _trace(run, probes)


def _trace(run: RunInputs, probes) -> SimTrace:
    """Stack the per-epoch probe records of a batch of one into a
    `SimTrace` on the CPU."""
    prbs, kfis, zs, place = zip(*probes)

    def stack(xs):
        return torch.stack(xs).cpu()

    acc = _ProbeAcc(*(stack(x) for x in zip(*prbs)))
    kfi = predictor.KFInternals(*(stack(x) for x in zip(*kfis)))
    # suppressed fabric elements per epoch + the telemetry-corruption flag
    f = tree_map(lambda x: x[0], run.faults)
    faults_active = (
        (~f.link_ok).sum((1, 2)).cpu() + (~f.router_ok).sum(1).cpu()
        + (~f.mc_ok).sum(1).cpu() + (f.telem_mode.cpu() != 0)
    ).to(_I32)
    return SimTrace(
        occ_sum=acc.occ, arb_grant=acc.grant, arb_deny=acc.deny,
        mcq_sum=acc.mcq_sum, mcq_max=acc.mcq_max,
        kf_innovation=kfi.innovation, kf_gain=kfi.gain,
        kf_cov_trace=kfi.cov_trace, kf_x_pred=kfi.x_pred,
        z_obs=stack(zs), kf_nis=kfi.nis, kf_rejected=kfi.rejected,
        kf_reset=kfi.reset, kf_healthy=kfi.healthy,
        faults_active=faults_active, place_cls=stack(place),
    )


def _first_row(result: SimResult) -> SimResult:
    return tree_map(lambda x: x[0], result)


def simulate(
    cfg: NoCConfig,
    source: TrafficSourceLike,
    *,
    device: str | torch.device | None = None,
    rng: torch.Generator | EpochStreams | None = None,
    engine: str | None = None,
) -> SimResult:
    """Run one configuration: a batch of one through the batch's epoch
    loop, so its bits are those of its row in any batch.

    ``device=None`` runs on the CUDA device and raises if there is none;
    pass ``device="cpu"`` for the plain-torch path.  ``rng`` None draws the
    reference's streams from ``cfg.seed`` with JAX's threefry (under the
    `threefry.threefry_partitionable` setting in force, True by default as
    in jax 0.9.0); it may also be a `torch.Generator` on the run's device
    or an epoch-stream provider (``epoch -> (u_phase, u_gen, d_idx)``).
    ``engine`` overrides ``cfg.engine``.  The result lives on the CPU.
    """
    return _first_row(_simulate_impl(run_inputs(
        cfg, source, device=device, rng=rng, engine=engine)))


def simulate_with_trace(
    cfg: NoCConfig,
    source: TrafficSourceLike,
    *,
    device: str | torch.device | None = None,
    rng: torch.Generator | EpochStreams | None = None,
    engine: str | None = None,
) -> tuple[SimResult, SimTrace]:
    """`simulate` with the flight recorder on: returns (SimResult,
    SimTrace), both on the CPU.  The SimResult is bitwise `simulate`'s on
    the same arguments; the SimTrace is bitwise equal across the three
    engines.  On the CUDA device the "fused" engine launches the probed
    cycle kernel (B3) once per epoch."""
    result, trace = _simulate_impl(
        run_inputs(cfg, source, device=device, rng=rng, engine=engine),
        probe=True,
    )
    return _first_row(result), trace


def _stack_results(parts: Sequence[SimResult]) -> SimResult:
    return tree_map(lambda *xs: torch.cat(xs), *parts)


def simulate_batch(
    cfgs: Sequence[NoCConfig],
    sources: TrafficSourceLike | Sequence,
    seeds: Sequence[int] | None = None,
    batch_tile: int | None = None,
    *,
    device: str | torch.device | None = None,
    engine: str | None = None,
) -> SimResult:
    """Evaluate many configurations in lockstep; each row's bits are its
    standalone `simulate`'s.

    cfgs       — length-B configs sharing one `static_spec()` (mode,
                 ratio, predictor, guard, control, faults, placement and
                 seed are per-row data).
    sources    — length-B demand sources, or one for all rows.
    seeds      — optional per-row seeds; defaults to each cfg's own.
    batch_tile — if set, rows run in tiles of this many (the ragged tail
                 padded by repeating row 0, the pad rows discarded);
                 None runs the whole batch as one tile.

    A tile is one batch with one epoch boundary for all its rows.  On the
    "fused" engine each epoch is ONE launch of the fused cycle kernel whose
    grid is the tile's rows (one block, one SM, per row); on the "ref" and
    "arb" engines each epoch walks the rows' cycles one row after another.
    The device-sharded path of the JAX package (`devices` / `mesh`,
    `sweep_sharded`) is left out: on one card the batch is the grid.
    Returns a `SimResult` whose leaves carry a leading (B,) axis, on the
    CPU, in input order.
    """
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("simulate_batch needs at least one config")
    n = len(cfgs)
    sources, seeds = _per_row(cfgs, sources, seeds)
    tile = n if batch_tile is None else batch_tile
    parts = []
    for lo in range(0, n, tile):
        idx = list(range(lo, min(lo + tile, n)))
        idx += [idx[0]] * (tile - len(idx))   # pad rows repeat row 0
        run = batch_inputs([cfgs[i] for i in idx], [sources[i] for i in idx],
                           seeds=[seeds[i] for i in idx], device=device,
                           engine=engine)
        res = _simulate_impl(run)
        parts.append(tree_map(lambda x: x[:min(tile, n - lo)], res))
    return _stack_results(parts)


class SweepSpec(NamedTuple):
    """One row of a sweep: a network config x workload x seed point.

    ``workload`` names any demand source `traffic.lookup_workload`
    resolves; ``predictor`` picks the bank member driving the hysteresis
    machine; ``guard`` arms the predictor's self-healing layer and
    ``control`` picks the lever(s) the applied config drives.  ``faults``
    names a registered fault scenario (`faults.FAULTS`) and ``placement``
    a registered placement scenario (`placement.PLACEMENTS`); either may
    also be a schedule, a ready stream, or None (healthy / the identity
    layout).  Rows that differ only in them share one `static_spec()`, so
    one batch.  A key of `sweep`'s overrides takes precedence over the
    per-spec value."""

    mode: str
    workload: str
    static_gpu_vcs: int = 2
    seed: int = 0
    predictor: str = "kf"
    faults: FaultSourceLike = None
    guard: bool = False
    placement: PlacementSourceLike = None
    control: str = "bandwidth"


# The JAX package's tile (its paper sweeps are multiples of 6 rows, so one
# executable serves them all with no padding).  Kept for parity; the
# port's `sweep` runs each group as ONE tile, because its kernel's grid is
# the batch: a tile of 6 would fill 6 of the card's 132 SMs.
SWEEP_TILE = 6


def sweep(
    specs: Sequence[SweepSpec],
    batch_tile: int | None = None,
    *,
    device: str | torch.device | None = None,
    **overrides,
) -> list[SimResult]:
    """Run a heterogeneous sweep, batching rows that share a structure.

    Rows are grouped by `static_spec()` (every mode shares one), each
    group runs through `simulate_batch` (one tile unless ``batch_tile``),
    and results come back as one `SimResult` per spec, in input order, on
    the CPU.  ``overrides`` are forwarded to every row's `NoCConfig` (e.g.
    n_epochs=30).  The JAX package's `sweep_sharded` (a device mesh) is
    left out: on one card the batch is the grid."""
    specs = list(specs)
    rows: list[SimResult | None] = [None] * len(specs)
    groups: dict[SimStatic, list[int]] = {}
    cfgs = []
    for i, sp in enumerate(specs):
        kw = dict(overrides)
        kw.setdefault("faults", sp.faults)
        kw.setdefault("guard", sp.guard)
        kw.setdefault("placement", sp.placement)
        kw.setdefault("control", sp.control)
        cfg = NoCConfig(
            mode=sp.mode, static_gpu_vcs=sp.static_gpu_vcs, seed=sp.seed,
            predictor=sp.predictor, **kw,
        )
        cfgs.append(cfg)
        groups.setdefault(cfg.static_spec(), []).append(i)
    for idxs in groups.values():
        res = simulate_batch(
            [cfgs[i] for i in idxs], [specs[i].workload for i in idxs],
            batch_tile=batch_tile, device=device,
        )
        for j, i in enumerate(idxs):
            rows[i] = tree_map(lambda x: x[j], res)
    return rows


def run_workload(mode: str, workload: str, *, device=None,
                 **overrides) -> SimResult:
    return simulate(NoCConfig(mode=mode, **overrides), workload, device=device)


def summarize(res: SimResult, warmup_epochs: int = 10) -> dict:
    """Means over the epochs after the warmup (the tail epoch for short
    runs)."""
    n_epochs = int(res.gpu_ipc.shape[-1])
    sl = slice(min(warmup_epochs, max(n_epochs - 1, 0)), None)
    return {
        "gpu_ipc": float(res.gpu_ipc[sl].float().mean()),
        "cpu_ipc": float(res.cpu_ipc[sl].float().mean()),
        "avg_latency": float(res.avg_latency[sl].float().mean()),
        "kf_on_frac": float(res.applied_config[sl].float().mean()),
    }


def summarize_seeds(rows: Sequence[SimResult], warmup_epochs: int = 10) -> dict:
    """Aggregate one point over its seed replicas: mean + `<k>_std`."""
    per = [summarize(r, warmup_epochs) for r in rows]
    out = {}
    for k in per[0]:
        vals = np.asarray([p[k] for p in per])
        out[k] = float(vals.mean())
        out[k + "_std"] = float(vals.std())
    return out
