"""The serving A/B driver and chip_smoke.py's switching workload on the CPU.

* `benchmarks/torch_kf_scheduler_ab.run` equals the JAX driver
  `benchmarks/kf_scheduler_ab.run` mode for mode: the summaries are on
  the Engine's virtual clock and the schedule does not depend on the
  model's numbers (the reference prefills all-zero prompts), so equality
  is the bar.  Few requests, because the JAX Engine compiles a prefill
  per prompt length.
* The second serving workload chip_smoke.py runs on the card (mean gen
  32, max_len 768) boosts and switches at smoke size on the CPU, on both
  served models; the card's EngineStats are held to this run."""
import pytest
import torch

import chip_smoke
import repro_torch.configs as configs
from benchmarks import kf_scheduler_ab as jab
from benchmarks import torch_kf_scheduler_ab as tab
from repro_torch.models import lm
from repro_torch.serve import batching
from repro_torch.serve.engine import Engine, EngineConfig

N_REQUESTS = 10


def test_scheduler_ab_equals_jax():
    want = jab.run(n_requests=N_REQUESTS)
    got = tab.run(n_requests=N_REQUESTS, device="cpu")
    assert list(got) == list(tab.MODES) == list(jab.MODES)
    assert got == want
    assert all(s["n_finished"] == N_REQUESTS for s in got.values())


def test_scheduler_ab_main_prints_table(monkeypatch, capsys):
    got = {m: dict(n_finished=1, mean_ttft=0.1, p90_ttft=0.2,
                   mean_latency=0.3 + i, throughput_tok_s=10.0 + i,
                   kf_on_frac=0.5) for i, m in enumerate(tab.MODES)}
    monkeypatch.setattr(tab, "run", lambda *a, **kw: got)
    tab.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("mode,n_finished")
    assert [ln.split(",")[0] for ln in out[1:4]] == list(tab.MODES)
    assert out[4].startswith("# kf vs rr: mean_latency")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "falcon-mamba-7b"])
def test_chip_smoke_second_workload_switches(arch):
    ekw, wkw = chip_smoke.SERVE_RUNS[1]
    assert (ekw["max_len"], wkw["mean_gen"]) == (768, 32)
    cfg = configs.smoke(arch)
    params = lm.make_lm(torch.Generator().manual_seed(chip_smoke.SEED), cfg)
    st = Engine(params, cfg, EngineConfig(mode="kf", **ekw),
                device="cpu").run(batching.generate(
                    batching.WorkloadConfig(**wkw)))
    assert len(st.finished) == wkw["n_requests"]
    assert (st.iters, sum(st.configs), chip_smoke.switches(st.configs)) == \
        (224, 23, 8)
    # prompts above max_len - gen - 1 are clipped by submit
    assert max(r.prompt_len for r in st.finished) <= ekw["max_len"] - 2


def test_chip_smoke_first_workload_never_boosts():
    """The first workload keeps the KF at config 0 (the reason for the
    second)."""
    ekw, wkw = chip_smoke.SERVE_RUNS[0]
    cfg = configs.smoke("llama3.2-3b")
    params = lm.make_lm(torch.Generator().manual_seed(chip_smoke.SEED), cfg)
    st = Engine(params, cfg, EngineConfig(mode="kf", **ekw),
                device="cpu").run(batching.generate(
                    batching.WorkloadConfig(**wkw)))
    assert len(st.finished) == wkw["n_requests"] and sum(st.configs) == 0
