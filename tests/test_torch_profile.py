"""The profiling helpers of the fx64 production step (the card-side run is
``python -m dc_sand_tpu_torch.profile_step``)."""

import torch

from dc_sand_tpu_torch.profile_step import device_busy_us, noise_int8


def test_device_busy_is_the_union_of_device_intervals():
    ev = [
        {"cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "b", "ts": 5.0, "dur": 10.0},
        {"cat": "kernel", "name": "c", "ts": 6.0, "dur": 2.0},     # inside
        {"cat": "gpu_memset", "name": "d", "ts": 30.0, "dur": 5.0},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 100.0},
        {"cat": "kernel", "name": "flow", "ts": 50.0},             # no dur
    ]
    assert device_busy_us(ev) == 20.0
    assert device_busy_us([]) == 0.0


def test_noise_int8_is_seeded_and_never_minus_128():
    def draw():
        gen = torch.Generator()
        gen.manual_seed(3)
        return noise_int8(gen, (40, 3, 64), "cpu")
    x = draw()
    assert x.dtype == torch.int8 and x.shape == (40, 3, 64)
    assert torch.equal(x, draw())
    assert int(x.min()) >= -127 and x.float().std() > 10
