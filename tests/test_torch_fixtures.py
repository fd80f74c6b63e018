"""The card runs' fixtures (``dc_sand_tpu_torch.bench.fixtures``): the
idle arithmetic of a trace's device intervals and the seeded noise."""

import torch

from dc_sand_tpu_torch.bench.fixtures import (card_spans_us, idle_share,
                                              noise_int8)


def test_device_busy_is_the_union_of_device_intervals():
    """``idle_share`` on one card: busy is the union of the card's device
    intervals (host ops and events without a duration left out), the
    idle share one minus busy over the wall; with no device interval, or
    none inside the window, no share."""
    ev = [
        {"cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "b", "ts": 5.0, "dur": 10.0},
        {"cat": "kernel", "name": "c", "ts": 6.0, "dur": 2.0},     # inside
        {"cat": "gpu_memset", "name": "d", "ts": 30.0, "dur": 5.0},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 100.0},
        {"cat": "kernel", "name": "flow", "ts": 50.0},             # no dur
    ]
    spans = card_spans_us(ev, base_us=100.0)
    assert list(spans) == [0] and len(spans[0]) == 4
    share, busy_ms, wall_ms, cards = idle_share(
        [{"window_us": (100.0, 140.0), "spans_us": spans}])
    assert (share, busy_ms, wall_ms, cards) == (0.5, 0.02, 0.04, 1)
    assert idle_share([{"window_us": (0.0, 40.0),
                        "spans_us": card_spans_us([])}])[:2] == (None, 0.0)
    assert idle_share([{"window_us": (0.0, 40.0),
                        "spans_us": spans}])[0] is None


def test_noise_int8_is_seeded_and_never_minus_128():
    def draw():
        gen = torch.Generator()
        gen.manual_seed(3)
        return noise_int8(gen, (40, 3, 64), "cpu")
    x = draw()
    assert x.dtype == torch.int8 and x.shape == (40, 3, 64)
    assert torch.equal(x, draw())
    assert int(x.min()) >= -127 and x.float().std() > 10
