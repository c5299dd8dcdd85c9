"""The port's full-scale certification (``raytracer_tpu_torch.certify``), a
twin of ``tests/test_certify.py``: the committed ``CERTIFY.json`` keeps its
acceptance thresholds; a downsampled tile of the certified workload (48x27,
2 spp, the full depth 8, the reference world) is bitwise equal across the
native C++ engine, the port's oracle and the port's parity renderer; and
``certify``'s statistics are the script's formulas
(``scripts/certify_fullscale.py``).  The full-size run needs the card:
``python -m raytracer_tpu_torch.certify`` (and ``chip_smoke.py`` 6c)."""

import json
from pathlib import Path

import numpy as np
import pytest

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import certify, native, oracle

ROOT = Path(__file__).resolve().parent.parent


def test_certify_artifact_within_thresholds():
    report = json.loads((ROOT / "CERTIFY.json").read_text())
    assert report["config"] == certify.CONFIG == {
        "width": 512, "height": 512, "spp": 64, "depth": 8,
        "scene": "default_world (reference world.txt)"}
    assert report["psnr_db"] > certify.PSNR_MIN_DB == 30.0
    assert report["mean_abs_diff_u8"] < certify.MEAN_ABS_MAX == 4.0
    assert len(report["native_parity_sha256"]) == 64
    assert certify.CERTIFY_JSON == ROOT / "CERTIFY.json"


def test_downsampled_tile_bit_exact_all_three():
    try:
        native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    W, H, SPP, D = 48, 27, 2, 8
    src = rtt.models.default_world_source()
    nat = native.NativeWorld(src).render(W, H, samples_per_pixel=SPP,
                                         max_ray_bounces=D)
    world = rtt.models.default_world()
    ocam, oworld = world.to_oracle()
    ref = oracle.ray_trace(oworld, ocam, W, H, SPP, D)
    assert np.array_equal(nat, ref)
    got = rtt.ray_trace_parity(world.to_scene(), world.to_camera(), W, H,
                               SPP, D, device="cpu")
    assert np.array_equal(got, ref)


def _script_stats(nat, fast):
    """scripts/certify_fullscale.py's formulas, as written there."""
    nat_rgb = np.asarray(nat)[..., :3].astype(np.int32)
    tpu_rgb = np.asarray(fast)[..., :3].astype(np.int32)
    diff = np.abs(nat_rgb - tpu_rgb)
    mse = float(np.mean((nat_rgb - tpu_rgb).astype(np.float64) ** 2))
    psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    return {"per_channel_max_diff_u8": [int(diff[..., c].max())
                                        for c in range(3)],
            "mean_abs_diff_u8": float(diff.mean()),
            "frac_pixels_diff_gt_8": float((diff.max(axis=-1) > 8).mean()),
            "psnr_db": psnr}


@pytest.mark.parametrize("seed,noise", [(0, 3), (1, 12), (2, 40), (3, 0)])
def test_stats_are_the_scripts_formulas(seed, noise):
    r = np.random.default_rng(seed)
    a = r.integers(0, 256, size=(37, 29, 4), dtype=np.uint8)
    b = np.clip(a.astype(int) + r.integers(-noise, noise + 1, a.shape), 0,
                255).astype(np.uint8)
    b[..., 3] = r.integers(0, 256, size=b.shape[:2])    # alpha is ignored
    got, want = certify.stats(a, b), _script_stats(a, b)
    assert got == want
    if noise == 0:
        assert got["psnr_db"] == 10.0 * np.log10(255.0 ** 2 / 1e-12)


def test_certify_on_a_small_config(monkeypatch, tmp_path, capsys):
    """The whole flow at a tiny configuration on the CPU: the native
    image's sha256 checked against the artifact, the report written, the
    exit code from the thresholds."""
    try:
        native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    small = dict(certify.CONFIG, width=16, height=9, spp=4, depth=3)
    nat = native.NativeWorld(rtt.models.default_world_source()).render(
        16, 9, samples_per_pixel=4, max_ray_bounces=3)
    artifact = tmp_path / "CERTIFY.json"
    artifact.write_text(json.dumps(
        {"config": small, "native_parity_sha256": certify.sha256(nat)}))
    monkeypatch.setattr(certify, "CONFIG", small)
    monkeypatch.setattr(certify, "CERTIFY_JSON", artifact)
    report = certify.certify(device="cpu")
    assert report["native_sha256_matches"]
    assert report["native_parity_sha256"] == certify.sha256(nat)
    assert report["fast_segments"] > 16 * 9 * 4
    assert report["certified"] == (report["psnr_db"] > 30.0
                                   and report["mean_abs_diff_u8"] < 4.0)
    out = tmp_path / "r.json"
    monkeypatch.setattr(certify, "certify", lambda: report)
    rc = certify.main(["--out", str(out)])
    assert rc == (0 if report["certified"] else 1)
    assert json.loads(out.read_text()) == report
    # a wrong artifact hash fails the certification whatever the PSNR
    artifact.write_text(json.dumps({"config": small,
                                    "native_parity_sha256": "0" * 64}))
    monkeypatch.undo()
    monkeypatch.setattr(certify, "CONFIG", small)
    monkeypatch.setattr(certify, "CERTIFY_JSON", artifact)
    bad = certify.certify(device="cpu")
    assert not bad["native_sha256_matches"] and not bad["certified"]
