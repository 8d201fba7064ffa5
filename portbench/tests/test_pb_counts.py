"""The kernel, FLOP and trace arithmetic against numbers worked by hand."""

import pytest
import torch

from harness import plugins, trace
from harness.peaks import HBM_RATE, PEAK_RATE


def test_attention_counts_valid_rows_and_keys_only():
    k = plugins.kernel("attention")
    qm = torch.zeros(1, 128, dtype=torch.bool)
    km = torch.zeros(1, 128, dtype=torch.bool)
    qm[0, :100] = True
    km[0, :50] = True
    call = k.note((torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16),
                   torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16), None, qm, km), {}, None)
    ops = 4 * 2 * 64 * 100 * 50                  # two products over valid rows x keys
    nbytes = 2 * 2 * 64 * (2 * 100 + 2 * 50)     # q, out per row; k, v per key; bf16
    assert k.least_seconds([call]) == pytest.approx(max(ops / PEAK_RATE["bf16"],
                                                        nbytes / HBM_RATE))
    f32 = call[:2] + (torch.float32,) + call[3:]
    assert k.least_seconds([f32]) is None        # an inexact count is left out


def test_sinkhorn_counts_bytes():
    k = plugins.kernel("sinkhorn")
    assert k.least_seconds([(2, 10, 20)]) == pytest.approx(4 * 2 * (200 + 20 + 60) / HBM_RATE)
    assert k.least_seconds([]) is None


def test_superpoint_flops_by_hand():
    common = plugins.flops("superpoint-lightglue")._common
    h = w = 1024
    by_hand = 2 * (h * w * (1 * 64 + 64 * 64) * 9 + (h // 2) * (w // 2) * (64 * 64 * 2) * 9
                   + (h // 4) * (w // 4) * (64 * 128 + 128 * 128) * 9
                   + (h // 8) * (w // 8) * ((128 * 128 * 2 + 128 * 256 * 2) * 9
                                            + 256 * 65 + 256 * 256))
    assert common.superpoint(h, w) == pytest.approx(by_hand)
    assert common.superpoint(h, w) / (h * w) == pytest.approx(169606, rel=1e-3)


def test_lightglue_flops_by_hand():
    f = plugins.flops("superpoint-lightglue")
    n0, n1, d = 3, 5, 4
    self_ = 2 * (n0 + n1) * (d * 3 * d + d * d + 2 * d * 2 * d + 2 * d * d) \
        + 2 * 2 * d * (n0 * n0 + n1 * n1)
    cross = 2 * (n0 + n1) * (3 * d * d + 2 * d * 2 * d + 2 * d * d) + 2 * 3 * n0 * n1 * d
    head = 2 * (n0 + n1) * d * d + 2 * n0 * n1 * d
    assert f.lightglue_pair(n0, n1, 2, d) == pytest.approx(2 * (self_ + cross) + head)


def test_superglue_flops_by_hand():
    f = plugins.flops("superpoint-superglue")
    n0, n1, d = 3, 5, 8
    enc = 2 * (3 * 32 + 32 * 64 + 64 * 128 + 128 * 256) * (n0 + n1)
    layer = 2 * (n0 + n1) * (4 * d * d + 2 * d * 2 * d + 2 * d * d)
    self_ = layer + 4 * d * (n0 * n0 + n1 * n1)
    cross = layer + 8 * d * n0 * n1
    head = 2 * (n0 + n1) * d * d + 2 * n0 * n1 * d
    assert f.superglue_pair(n0, n1, 1, d) == pytest.approx(enc + self_ + cross + head)


def test_device_busy_is_a_union_not_a_sum():
    t = trace.DeviceTrace([(0, "k", 0, 10), (0, "copy", 5, 15), (0, "k", 20, 30),
                           (1, "k", 0, 40)])
    assert t.busy_ns([(0, 40)]) == {0: 25, 1: 40}
    assert t.busy_ns([(8, 25)]) == {0: 12, 1: 17}
    # only inside the jobs: the harness's time between two jobs counts for neither
    assert t.busy_ns([(0, 8), (12, 25)]) == {0: 16, 1: 21}
    assert trace.gaps(trace.union_ns([(0, 10), (5, 15), (20, 30)]), 0, 40) == [(15, 20), (30, 40)]


def test_idle_gaps_named_by_span():
    t = trace.DeviceTrace([(0, "k", 0, 10), (0, "k", 30, 40), (0, "k", 45, 50)])
    spans = [("job", 0, 50), ("match_pairs", 5, 42)]
    assert t.idle_gaps([(0, 50)], spans, 2) == [["match_pairs", 20e-9], ["job", 5e-9]]
    # two jobs, (0, 20) and (25, 50): the idle time between them is no gap
    spans = [("job", 0, 20), ("job", 25, 50)]
    assert t.idle_gaps([(0, 20), (25, 50)], spans, 3) == [["job", 10e-9], ["job", 5e-9],
                                                           ["job", 5e-9]]


def test_kernel_names_match_without_signatures():
    t = trace.DeviceTrace([(0, "(anonymous namespace)::attention_sm90(CUtensorMap_st, int)", 0, 7),
                           (0, "void (anonymous namespace)::sinkhorn_iter_kernel<8>(float)", 0, 3),
                           (0, "void at::native::elementwise_kernel<128>(int)", 0, 5)])
    assert t.kernel_ns(plugins.kernel("attention").DEVICE_NAMES) == 7
    assert t.kernel_ns(plugins.kernel("sinkhorn").DEVICE_NAMES) == 3
