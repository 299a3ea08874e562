"""The port's utils/ssim.py and utils/refcompare.py against the JAX
package's, its PNG reader against PIL on the golden images, and the port's
plain CPU Engine against tests/golden/ (configs 1, 2, 3, 5 and 6 at 96x96,
SSIM >= 0.98, as tests/test_golden.py holds the JAX Engine). The card's
frames meet the same goldens at 96x96 and 256x256 in chip_smoke.py phase 14.
"""
import glob
import os

import numpy as np
import pytest
from PIL import Image

import _torch_scenes as S
from raytracevs_tpu.utils import refcompare as JRC
from raytracevs_tpu.utils import ssim as JSSIM
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io.png import read_png
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.utils import refcompare as PRC
from raytracevs_tpu_torch.utils import ssim as PSSIM
from test_refcompare import _gradient

S.one_torch_thread()

GOLDEN_PNGS = sorted(glob.glob(os.path.join(S.GOLDEN_DIR, "*.png")))


def _image_pair(kind):
    rng = np.random.default_rng(12)
    if kind == "uint8 rgba":
        a = rng.integers(0, 256, (40, 56, 4), dtype=np.uint8)
        b = np.clip(a.astype(np.int16) + rng.integers(-30, 31, a.shape), 0, 255).astype(np.uint8)
    elif kind == "float gray":
        a = rng.uniform(0.0, 255.0, (33, 47))
        b = a + rng.normal(0.0, 12.0, a.shape)
    else:  # identical
        a = rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)
        b = a.copy()
    return a, b


@pytest.mark.parametrize("kind", ["uint8 rgba", "float gray", "identical"])
def test_ssim_equals_jax(kind):
    a, b = _image_pair(kind)
    got, want = PSSIM.ssim(a, b), JSSIM.ssim(a, b)
    assert got == want  # the same numpy code: bit for bit
    if kind == "identical":
        assert got == 1.0
    else:
        assert 0.0 < got < 1.0


def test_ssim_shape_mismatch_raises_in_both():
    a, b = np.zeros((20, 20)), np.zeros((20, 21))
    for mod in (PSSIM, JSSIM):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.ssim(a, b)


@pytest.mark.parametrize("src, ref", [((135, 240), (135, 240)), ((136, 240), (135, 240))],
                         ids=["matched", "1088-to-1080-aspect"])
def test_warp_and_compare_equal_jax(src, ref):
    img = _gradient(*src)
    got, got_cols = PRC.warp_to_reference(img, ref_h=ref[0], ref_w=ref[1])
    want, want_cols = JRC.warp_to_reference(img, ref_h=ref[0], ref_w=ref[1])
    assert got_cols == want_cols
    np.testing.assert_array_equal(got, want)
    if src == ref:
        assert got_cols == slice(0, ref[1])
    else:
        assert 0 < got_cols.start and got_cols.stop < ref[1]
    rng = np.random.default_rng(5)
    reference = np.clip(_gradient(*ref) + rng.normal(0.0, 8.0, ref + (3,)), 0, 255)
    reference = np.concatenate([reference, np.full(ref + (1,), 255.0)], -1).astype(np.uint8)
    got, want = (m.compare_to_reference(img, ref=reference, grid=3) for m in (PRC, JRC))
    assert got == want
    assert set(got["regions"]) == {f"r{i}c{j}" for i in range(3) for j in range(3)}


def test_compare_without_the_screenshot_raises_in_both(tmp_path, monkeypatch):
    absent = str(tmp_path / "ScreenShot.png")
    for mod in (PRC, JRC):
        monkeypatch.setattr(mod, "REF_SCREENSHOT", absent)
        with pytest.raises(FileNotFoundError):
            mod.compare_to_reference(_gradient(16, 16))
    assert PRC.REF_SCREENSHOT == JRC.REF_SCREENSHOT


def test_golden_images_are_all_here():
    # configs 0-6, each at 96x96 and 256x256
    assert len(GOLDEN_PNGS) == 14
    for name in S.GOLDEN_RENDERED:
        for res in (96, 256):
            assert os.path.exists(S.golden_path(name, res))


@pytest.mark.parametrize("path", GOLDEN_PNGS, ids=os.path.basename)
def test_read_png_equals_pil(path):
    pil = Image.open(path)
    assert pil.mode == "RGBA"
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(pil))


@pytest.mark.parametrize("name", S.GOLDEN_RENDERED)
def test_golden_cpu(name):
    golden = read_png(S.golden_path(name, 96))
    img, _ = S.render_golden(Engine, PD, name, 96, device="cpu")
    assert img.shape == golden.shape == (96, 96, 4)
    score = PSSIM.ssim(img, golden)
    assert score >= S.SSIM_THRESHOLD, f"{name}: SSIM {score:.4f} < {S.SSIM_THRESHOLD}"
    # refcompare on the golden as its reference gives the same score, every
    # column covered (matched shape)
    out = PRC.compare_to_reference(img, ref=golden)
    assert out["ssim"] == round(score, 4)
