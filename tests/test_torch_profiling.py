"""The port's profiler window (``fastdem_tpu_torch.utils.profiling``): how
many windows ``device_profile`` takes, and what it returns. On the CPU no
window records a device event; the card test is in ``test_torch_cuda.py``."""

import pytest
import torch

from fastdem_tpu_torch.utils import profiling
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("attempts", [1, 3])
def test_device_profile_measures_again_then_raises(attempts, monkeypatch):
    """A window with no device time is measured again, ``attempts`` windows
    of ``reps`` calls in all, and then it raises."""
    monkeypatch.setattr(profiling, "PROFILE_PAD_S", 0.0)
    x = torch.zeros(8)
    calls = []
    with pytest.raises(RuntimeError, match=f"no device time in {attempts} window"):
        profiling.device_profile(lambda: calls.append(x.add_(1.0)), 4, attempts=attempts)
    assert len(calls) == 4 * attempts
    assert float(x[0]) == 4 * attempts


def test_device_profile_sums_the_window_it_keeps(monkeypatch):
    """The first window with device time is the one returned: ms, events
    and each name's (events, ms) per call, without another window."""
    windows = iter([{}, {"k": (6, 30.0), "memset": (2, 6.0)}, {"k": (1, 1.0)}])
    monkeypatch.setattr(profiling, "profile_window",
                        lambda fn, reps, pad_s=0.0: ("prof", next(windows)))
    ms, events, by_name, prof = profiling.device_profile(lambda: None, 2, attempts=3)
    assert prof == "prof"
    assert ms == pytest.approx(0.018) and events == 4.0
    assert by_name == {"k": (3.0, pytest.approx(0.015)), "memset": (1.0, pytest.approx(0.003))}
    assert next(windows) == {"k": (1, 1.0)}


def test_profile_window_pads_both_ends(monkeypatch):
    """The window sleeps ``pad_s`` before the first call and after the
    last, inside the profiler."""
    order = []
    monkeypatch.setattr(profiling.time, "sleep", lambda s: order.append(("sleep", s)))
    _, events = profiling.profile_window(lambda: order.append("call"), 2, 0.5)
    assert order == [("sleep", 0.5), "call", "call", ("sleep", 0.5)]
    assert events == {}
