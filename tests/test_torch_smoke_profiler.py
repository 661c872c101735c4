"""chip_smoke.py's reading of torch.profiler sessions, on the CPU.

The card's tracing has been seen to drop a whole session's device records,
or some of them.  A dropped record is a gap in the measurement, not a
fault of the program: the device time it would have given is reported as
not measured, and the script goes on.  The checks that rest on the host's
launch calls (one launch a call) still hold.  Sessions are faked here, so
nothing needs a card."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import chip_smoke


def _event(device_type, name, us=0.0):
    return SimpleNamespace(device_type=device_type, name=name, key=name,
                           self_cpu_time_total=us,
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


def _session(launches: int, kernels: int, copies: int = 0):
    """Host launch calls, device kernels of 10 us each, and copies."""
    return ([_event(DeviceType.CPU, "cudaLaunchKernel", 2.0)] * launches
            + [_event(DeviceType.CUDA, "flash_fwd_sm90_kernel", 10.0)]
            * kernels
            + [_event(DeviceType.CUDA, "Memcpy HtoD (Pageable -> Device)",
                      1.0)] * copies)


@pytest.fixture
def fake_profiler(monkeypatch):
    """Replaces torch.profiler.profile by sessions that record the given
    event lists in turn; returns the list of sessions still to come."""
    sessions = []

    class Profile:
        def __init__(self, **_):
            self._events = sessions.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def events(self):
            return self._events

        def key_averages(self):
            return [e for e in self._events if e.device_type == DeviceType.CPU]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return sessions


def test_launch_records_counts_kernels_apart_from_copies():
    launches, kernels, records = chip_smoke.launch_records(_session(4, 3, 2))
    assert (launches, kernels, len(records)) == (4, 3, 5)
    assert records[0] == ("flash_fwd_sm90_kernel", 0.01)


@pytest.mark.parametrize("sessions, busy, note", [
    ([_session(5, 5)], 0.05, ""),                         # whole at once
    ([_session(5, 0), _session(5, 2), _session(5, 5)], 0.05, ""),
    ([_session(5, 0)] * 3, 0.0, ""),                      # dropped wholly
    ([_session(5, 4)] * 3, 0.0, ""),                      # dropped in part
    ([_session(0, 0, 5)], 0.005, ""),                     # copies only
])
def test_profile_device_whole_measures_only_a_whole_session(
        fake_profiler, sessions, busy, note):
    """A kernel's own time: a session with a launch missing would read as
    a faster kernel, so it is profiled again, then not measured."""
    fake_profiler.extend(sessions)
    _, got, top_dev, _, got_note = chip_smoke.profile_device(
        lambda: None, 1, whole=True)
    assert (got, got_note) == (pytest.approx(busy), note)
    assert bool(top_dev) == (busy > 0)
    assert not fake_profiler                  # no session more than needed
    assert "not measured" in chip_smoke.fmt_ms(0.0)


@pytest.mark.parametrize("sessions, busy, note", [
    ([_session(5, 5)], 0.05, ""),
    ([_session(5, 0), _session(5, 4)], 0.04, " (4 of 5 launches recorded)"),
    ([_session(5, 0)] * 3, 0.0, ""),                      # dropped wholly
])
def test_profile_device_reports_a_partial_session(fake_profiler, sessions,
                                                  busy, note):
    """A whole model call's busy time: a partial session is reported with
    the share it recorded, and profiled again only if it recorded
    nothing."""
    fake_profiler.extend(sessions)
    _, got, top_dev, _, got_note = chip_smoke.profile_device(lambda: None, 1)
    assert (got, got_note) == (pytest.approx(busy), note)
    assert bool(top_dev) == (busy > 0)
    assert not fake_profiler


def test_one_kernel_each_without_device_records(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "device_launches", lambda fn, n: (n, []))
    assert chip_smoke.one_kernel_each(None, 50, "kf_bank_kernel", "kf") == 0
    assert "not measured" in capsys.readouterr().out


@pytest.mark.parametrize("launches, records", [
    (49, []),                                    # a launch missing
    (51, [("kf_bank_kernel", 0.01)] * 51),       # one launch too many
    (50, [("elementwise_kernel", 0.01)] * 50),   # another kernel
    (50, [("kf_bank_kernel", 0.01)] * 49 + [("Memset (Device)", 0.001)]),
])
def test_one_kernel_each_still_fails(monkeypatch, launches, records):
    monkeypatch.setattr(chip_smoke, "device_launches",
                        lambda fn, n: (launches, records))
    with pytest.raises(SystemExit):
        chip_smoke.one_kernel_each(None, 50, "kf_bank_kernel", "kf")


def test_one_kernel_each_mean_of_the_recorded_launches(monkeypatch):
    records = [("kf_bank_kernel", 0.01)] * 30 + [("kf_bank_kernel", 0.03)] * 10
    monkeypatch.setattr(chip_smoke, "device_launches",
                        lambda fn, n: (50, records))
    assert chip_smoke.one_kernel_each(None, 50, "kf_bank_kernel",
                                      "kf") == pytest.approx(0.015)
