"""The counts the rooflines and shares divide by, from shapes: PERF.md's
figures, the program's own parameter count, and a decode step's bytes
growing with the positions held, not the cache's length."""
import pytest

from perfbench import spec
from perfbench.counts import decode, model, ssd
from perfbench.counts.peaks import bound_s

BENCH = spec.benchmark()
MAMBA2 = spec.config("mamba2_370m", BENCH)["model"]
ZAMBA2 = spec.config("zamba2_1p2b", BENCH)["model"]


def test_ssd_backward_bound_at_mamba2_b8_t1024_fp32():
    b, f = ssd.backward(8, 1024, 32, 64, 1, 128, 64, 4)
    assert bound_s(b, f, "float32") * 1e3 == pytest.approx(0.38663, abs=5e-6)


def test_model_flops_of_a_mamba2_step_of_8_x_1024():
    assert 6 * model.flops_params(MAMBA2) * 8 * 1024 / 1e12 == \
        pytest.approx(18.10, abs=0.005)


@pytest.mark.parametrize("name,m", [("mamba2_370m", MAMBA2),
                                    ("zamba2_1p2b", ZAMBA2)])
def test_parameter_count_is_the_programs(name, m):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    p = lm.init_params(get_config(name), device="meta")

    def numel(t):
        return sum(numel(v) for v in t.values()) if isinstance(t, dict) \
            else t.numel()
    assert model.param_count(m) == numel(p)


def test_zamba2_decode_bytes_follow_positions_held_not_cache_length():
    one = decode.step_bytes(ZAMBA2, "bfloat16", 32, 32 * 1000)
    two = decode.step_bytes(ZAMBA2, "bfloat16", 32, 32 * 2000)
    assert two - one == 32 * 1000 * decode.kv_row_bytes(ZAMBA2, "bfloat16")
    assert decode.kv_row_bytes(ZAMBA2, "bfloat16") == 114688
    # nothing in the count reads the engine's max_cache_len
    assert decode.step_bytes(MAMBA2, "bfloat16", 64, 10 ** 6) == \
        decode.step_bytes(MAMBA2, "bfloat16", 64, 0)


def test_ssd_forward_counts_match_check_ssd_at_mamba2_t512():
    b, f = ssd.forward(1, 512, 32, 64, 1, 128, 64, 2, final=True)
    # chip_smoke.check_ssd: x, B, C in bf16, dt fp32, the fp32 state
    assert b == (2 * 512 * 32 * 64 + 2 * 512 * 128) * 2 + 4 * 512 * 32 \
        + 8 * 32 + 4 * 32 * 64 * 128
    assert f == 32 * 8 * (2 * 64 * 64 * 128 + 2 * 64 * 64 * 64
                          + 4 * 64 * 64 * 128)
