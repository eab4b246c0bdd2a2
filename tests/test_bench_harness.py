"""Unit tests for bench.py's device bookkeeping: every result names the
device it ran on, and rates are divided only by a published peak of a
known card."""

import pytest

import bench


def test_peak_table_knows_the_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_tflops"] == 989.0
    assert peaks["hbm_tb_per_s"] == 3.35
    assert "data sheet" in peaks["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_raises_on_unknown_device(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


def test_device_fields_name_the_device():
    fields = bench._device_fields()
    assert fields["platform"] == "cpu"
    assert fields["device_kind"] == "cpu"
    assert fields["device_count"] >= 1
    assert "card_name_power_limit" in fields
