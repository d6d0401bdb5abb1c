"""``utils/profiling._intact``: which profile windows ``kernel_sequence``
counts.  A window opens and closes with MARKERS marker kernels, each group
a host pause of SETTLE_S away from the profiled calls; the profile may miss
the kernels launched first after it starts, so a window counts only where
it kept every closing marker and at least one opening one."""

from types import SimpleNamespace

import pytest

from retinanet_tpu_torch.utils import profiling
from retinanet_tpu_torch.utils.profiling import MARKER, MARKERS, SETTLE_S

GAP_US = SETTLE_S * 1e6  # one host pause, in the profile's microseconds


def kernel(name, start_us):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start_us, end=start_us + 1.0))


def window(opening, calls, closing):
    """Kernels of a window that kept ``opening`` and ``closing`` markers
    around ``calls`` kernels of the profiled calls, sorted by start."""
    events = [kernel(MARKER, 2.0 * i) for i in range(MARKERS - opening,
                                                     MARKERS)]
    t = 2.0 * MARKERS + GAP_US
    events += [kernel("b4_group_norm::gn_cluster", t + 5.0 * i)
               for i in range(calls)]
    t += 5.0 * calls + GAP_US
    events += [kernel(MARKER, t + 2.0 * i) for i in range(closing)]
    return events


@pytest.mark.parametrize("opening,calls,closing,intact", [
    (MARKERS, 14, MARKERS, True),
    (1, 14, MARKERS, True),  # the profile missed its first 15 kernels
    (MARKERS, 0, MARKERS, True),  # calls that launch nothing still count
    (0, 14, MARKERS, False),  # every opening marker lost: so may the calls
    (0, 0, MARKERS, False),
    (MARKERS, 14, MARKERS - 1, False),  # the window lost its last kernel
    (MARKERS, 14, 0, False),
    (0, 0, 0, False),
])
def test_a_window_counts_only_where_it_kept_its_markers(opening, calls,
                                                        closing, intact):
    assert profiling._intact(window(opening, calls, closing)) is intact
