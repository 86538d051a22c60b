"""Pin the bench stdout contract: a reader may capture only ~2000 chars of
output and parses the final line as JSON, so the stdout line must stay
under budget no matter how many sweep/array fields the full record grows,
and it always names the device the numbers were measured on."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import _STDOUT_BUDGET, slim_line  # noqa: E402


def _full_record():
    out = {
        "metric": "ADC search QPS/device (1M x 128d, 256-bit VAQ)",
        "value": 400123.4, "unit": "qps", "vs_baseline": 1.0,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
        "recall_at_10": 0.3195, "recall_at_100": 0.3944,
        "recall_at_10_refined": 0.7252, "batch_latency_ms": 2.561,
        "n": 1_000_000, "config": "VAQ256m32min7max8var1,HEAP",
        "value_runs": [396.1, 398.0, 400.1, 402.6, 455.0],
        "value_spread_pct": 15.0,
        "oracle_delta_recall": -0.0166,
        "ivf_qps": 124000.0, "ivf_recall_at_k": 0.3077, "ivf_visit": 0.1,
        "serving_sweep": [{"offered": o, "achieved": o * 0.97,
                           "p50_ms": 38.0, "p95_ms": 45.0,
                           "sustained": True} for o in range(2000, 9000,
                                                             500)],
        "codes_serving_sweep": [{"offered": o, "achieved": o,
                                 "p50_ms": 45.0, "p95_ms": 60.0,
                                 "sustained": False}
                                for o in range(2000, 9000, 500)],
        "serving_knee_qps": 3000.0, "serving_p50_ms": 38.2,
        "serving_p95_ms": 49.8, "codes_serving_knee_qps": 2500.0,
        "tenm_qps": 63562.6, "tenm_recall_at_k": 0.2423,
        "tenm_ivf_sweep": [{"visit": v, "qps": 50000.0, "ms": 15.0,
                            "recall_at_k": 0.236}
                           for v in (0.25, 0.1, 0.05)],
        "tenm_ivf_qps": 79673.0, "tenm_ivf_visit": 0.05,
        "tenm_ivf_recall_at_k": 0.2378,
        "tenm_codes_qps": 20126.8, "tenm_codes_recall_at_k": 0.2403,
        "codes_qps": 157000.3, "codes_recall_at_k": 0.3194,
        "fast4_qps": 204600.0, "decoded8_qps": 155000.1,
        "hamming_qps": 198900.2, "build_s": 69.0, "tenm_build_s": 97.0,
    }
    return out


def test_slim_line_under_driver_window():
    line = slim_line(_full_record())
    assert len(line) <= _STDOUT_BUDGET
    parsed = json.loads(line)
    # the headline, its device and the section headlines survive slimming
    for key in ("value", "device", "ivf_qps", "tenm_qps", "tenm_ivf_qps"):
        assert key in parsed, key
    # array-valued fields never reach stdout
    for key in ("serving_sweep", "tenm_ivf_sweep", "value_runs"):
        assert key not in parsed, key


def test_slim_line_truncates_errors_and_survives_bloat():
    out = _full_record()
    out["capacity_error"] = "RuntimeError(" + "x" * 5000 + ")"
    # hostile: a whitelisted field with a huge value still gets trimmed by
    # the tail-drop loop rather than blowing the budget
    out["config"] = "VAQ" + "9" * 1200
    line = slim_line(out)
    # the tail-drop loop sheds the bloated field (config is droppable)
    assert len(line) <= _STDOUT_BUDGET
    parsed = json.loads(line)
    assert len(parsed["capacity_error"]) <= 80
    assert parsed["value"] == 400123.4
    assert parsed["device"]["platform"] == "gpu"


def test_slim_line_normal_case_parses_with_all_sections():
    out = _full_record()
    line = slim_line(out)
    parsed = json.loads(line)
    assert parsed["tenm_ivf_visit"] == 0.05
    assert parsed["serving_knee_qps"] == 3000.0
