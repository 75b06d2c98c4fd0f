"""Config + observability smoke tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from radix_sort_tpu.config import DEFAULT
from radix_sort_tpu.utils.profiling import (
    PEAK_HBM_BYTES_PER_S, PhaseTimer, peak_hbm_bytes_per_s, speed_of_light_s,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_config_is_frozen():
    import dataclasses

    with pytest.raises(dataclasses.FrozenInstanceError):
        DEFAULT.default_implementation = "oracle"


def test_phase_timer_report(rng):
    t = PhaseTimer()
    x = jnp.asarray(rng.integers(0, 100, 1024, dtype=np.uint32))
    t.time_fn("add", lambda a: a + 1, x, bytes_moved=x.size * 8)
    with t.phase("noop"):
        pass
    rep = t.report(H100)
    assert "add" in rep and "total" in rep and "GB/s" in rep


def test_speed_of_light_monotone():
    assert speed_of_light_s(2_000_000, H100) == 2 * speed_of_light_s(
        1_000_000, H100)


def test_peak_table_knows_the_h100():
    # NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3
    assert peak_hbm_bytes_per_s(H100) == 3.35e12
    assert speed_of_light_s(3_350_000_000, H100) == pytest.approx(1e-3)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_rejects_unknown_kinds(kind):
    assert kind not in PEAK_HBM_BYTES_PER_S
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        peak_hbm_bytes_per_s(kind)
    with pytest.raises(ValueError):
        PhaseTimer().report(kind)


def test_peak_table_rejects_this_cpu_device():
    import jax

    with pytest.raises(ValueError):
        peak_hbm_bytes_per_s(jax.devices()[0].device_kind)
