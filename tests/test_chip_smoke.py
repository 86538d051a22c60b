"""chip_smoke.py at a tiny size on the CPU: every phase's checks pass, the
four-card phases pass on 4 virtual devices, and the script refuses to run
(non-zero exit, no result line) where JAX's first device is not a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TINY = ["--n", "16384", "--d", "64", "--queries", "80", "--gt-n", "4096",
        "--ref-queries", "32", "--fast-queries", "8", "--clusters", "16"]


def _ctx(argv):
    from vaq_tpu.data import make_anisotropic_gaussian

    args = chip_smoke.parse_args(argv)
    base, queries = make_anisotropic_gaussian(args.n, args.d, args.queries,
                                              seed=args.seed)
    return {"base": base, "queries": queries, "seed": args.seed,
            "gt_n": args.gt_n, "ref_nq": args.ref_queries,
            "fast_nq": args.fast_queries, "clusters": args.clusters}


@pytest.fixture(scope="module")
def built():
    """The shared context after the main phase (the index the later phases
    serve)."""
    ctx = _ctx(TINY)
    checks, mem = chip_smoke.phase_main(ctx)
    return ctx, checks, mem


def test_main_phase(built):
    _, checks, mem = built
    assert checks.ok, checks.items
    assert set(checks.items) >= {"k10_overlap_vs_lut_scan",
                                 "k100_dist_err_over_bound",
                                 "save_load_same_ids_frac"}
    assert mem["temp"] >= 0


@pytest.mark.parametrize("name", ["groundtruth", "serve", "codes",
                                  "decoded8", "ivf", "fast4", "hamming"])
def test_phase_passes_on_cpu(built, name):
    ctx, _, _ = built
    fn = dict(chip_smoke.PHASES)[name]
    checks, _ = fn(ctx)
    assert checks.ok, checks.items
    assert checks.items


def test_four_card_phases_on_virtual_devices():
    import jax

    devices = jax.devices()[:4]
    assert len(devices) == 4
    ctx = _ctx(["--n", "8192", "--d", "64", "--queries", "64",
                "--clusters", "16"])
    for name, fn in chip_smoke.FOUR_PHASES:
        checks, _ = fn(ctx)
        assert checks.ok, (name, checks.items)


def test_run_prints_result_line_last(capsys):
    """run() (the part main() reaches on a GPU) ends with the one JSON
    line naming the device."""
    import json

    import jax

    rc = chip_smoke.run(chip_smoke.parse_args(TINY + ["--phases",
                                                      "groundtruth"]),
                        jax.devices())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    last = json.loads(out[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}
    assert any(line.startswith("phase=groundtruth ok=true") for line in out)


def test_run_fails_when_a_check_fails(capsys, monkeypatch):
    monkeypatch.setitem(chip_smoke.MIN_OVERLAP, "decoded", 1.01)
    rc = chip_smoke.run(chip_smoke.parse_args(TINY + ["--phases", "main"]),
                        __import__("jax").devices())
    out = capsys.readouterr().out
    assert rc != 0
    assert "phase=main ok=false" in out
    assert not any(line.startswith('{"ok": true')
                   for line in out.splitlines())


def test_main_refuses_without_gpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out
    assert out.startswith("card: ")
