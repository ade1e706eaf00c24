"""The FLOP and byte counters against counts made by hand at tiny shapes."""

import pytest

from benchmark import work

F = work.FieldShape(depth=2, width=16, multires=1, multires_views=1)  # in_ch 9, view_ch 9


def test_field_shape_counts():
    assert (F.n_blocks, F.in_ch, F.view_ch) == (1, 9, 9)
    # lin_in 9x16+16, one block 2x(16x16+16), lin_out 16x16+16, alpha 16+1,
    # feature 16x16+16, views (16+9)x8+8, rgb 8x3+3
    assert F.n_params == 160 + 544 + 272 + 17 + 272 + 208 + 27


def test_kernel_work_by_hand():
    n = 10
    w = work.kernel_work(F, n, 1, True, input_grads=False, warped=False)
    macs = 9 * 16 + 4 * 256 + 16 + 25 * 8 + 24  # lin_in, 2 block + lin_out + feature, alpha, views, rgb
    data = macs - (9 * 16 + 9 * 8)
    assert w["fwd"][0] == 2 * macs * n
    assert w["bwd"][0] == 2 * (macs + data) * n
    act = 2 * (5 * 16 + 8)
    assert w["fwd"][1] == n * (24 + act + 16) + 4 * F.n_params
    assert w["bwd"][1] == n * (24 + act + 16) + 8 * F.n_params
    tile = n * (24 + (act - 32) + act + 16 + 2 * (64 + 64)) + 4 * F.n_params
    assert w["bwd_tile"] == (2 * data * n, tile)
    warped = work.kernel_work(F, n, 1, True, input_grads=False, warped=True)
    assert warped["bwd"][0] == 2 * 2 * macs * n


def test_bound_picks_the_larger():
    assert work.bound(989e9, 1.0) == (pytest.approx(1.0), "operations")
    assert work.bound(1.0, 3.35e9) == (pytest.approx(1.0), "bytes")
    assert work.bound(67e9, 1.0, work.PEAK_F32) == (pytest.approx(1.0), "operations")


def test_gemm_and_sums_by_hand():
    call = work.FieldCall("c", F, n=2048)
    shapes = [(64, 16), (16, 16), (16, 16), (16, 16), (16, 16), (16, 8), (64, 8)]
    assert work.wgrad_shapes(16, 1) == shapes
    sizes = sum(k * m for k, m in shapes)
    flop, nbytes = work.wgrad_work(call)
    assert flop == 2 * 2048 * sizes
    assert nbytes == sum(2 * 2048 * (k + m) for k, m in shapes) + 4 * sizes
    total = 16 + 32 + 16 + 16 + 8 + 1 + 3 + 16 + 24 + 12
    assert work.partial_total(16, 1) == total
    splits = max(1, min(264 // 7, 2), 1)  # 7 row tiles, 2048 // 1024 points
    (f1, b1), (f2, b2) = work.sum_rows_work(call)
    assert (f1, b1) == (32 * total, 4 * (32 * total + total))
    assert (f2, b2) == (splits * sizes, 4 * (splits * sizes + sizes))


FLAGS = dict(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=16, multires=1,
             multires_views=1, N_rand=4, N_samples=3, N_importance=5, num_vehicles=2)


def test_step_calls_and_flop():
    from benchmark.steps import appinit, online

    shared = online.calls(FLAGS, {})
    assert [(c.field.depth, c.n, c.fields, c.warped) for c in shared] == [
        (2, 12, 1, False), (2, 32, 1, False), (1, 12, 1, True), (1, 32, 1, True),
        (1, 12, 1, True), (1, 32, 1, True)]
    assert [(c.n, c.warped) for c in appinit.calls(FLAGS, {})] == [(12, False), (32, False)]
    one = work.kernel_work(F, 12, 1, True, False, False)
    assert work.step_flop(shared[:1]) == one["fwd"][0] + one["bwd"][0]


def test_step_calls_expand_the_frozen_cases():
    from benchmark.steps import online

    G = work.FieldShape(depth=1, width=16, multires=1, multires_views=1)
    cases = work.kernel_cases(F, G, 4, 3, 5, 2)
    expanded = sorted((f.depth, n, warped) for _, f, n, warped, calls in cases
                      for _ in range(calls))
    shared = online.calls(FLAGS, {})
    assert sorted((c.field.depth, c.n, c.warped) for c in shared) == expanded
