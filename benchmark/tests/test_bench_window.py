"""rays_per_s and step_ms_p95 over a synthetic window: a stall must move
both."""

from benchmark.run import end_to_end


def test_a_stall_moves_both():
    steps, rays = 400, 1000
    ms = [60.0 + 0.01 * (i % 7) for i in range(steps)]
    base = end_to_end(steps, rays, sum(ms) / 1e3, ms, 12.0)
    assert abs(base["rays_per_s"] - steps * rays / (sum(ms) / 1e3)) < 1e-6
    assert 60.0 < base["step_ms_p95"] < 60.1
    stalled = list(ms)
    for i in range(0, steps, 10):  # one step in ten waits 80 ms more (host, allocator, sync)
        stalled[i] += 80.0
    worse = end_to_end(steps, rays, sum(stalled) / 1e3, stalled, 12.0)
    assert worse["rays_per_s"] < 0.9 * base["rays_per_s"]
    assert worse["step_ms_p95"] > 130.0
    assert worse["setup_s"] == base["setup_s"] == 12.0


def test_the_tail_is_of_every_step():
    ms = [10.0] * 94 + [50.0] * 6
    assert end_to_end(100, 1, 1.0, ms, 0.0)["step_ms_p95"] > 10.0
    ms = [10.0] * 96 + [50.0] * 4
    assert end_to_end(100, 1, 1.0, ms, 0.0)["step_ms_p95"] < 50.0
