"""SSIM image comparison for golden-render checks (numpy).

Standard Wang et al. SSIM with a Gaussian window: a copy of
raytracevs_tpu/utils/ssim.py, which the tests hold equal bit for bit. The
golden-image checks score a frame against tests/golden/*.png with it
(SSIM >= 0.98 per config)."""
from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2D correlation via stride tricks (no scipy dependency)."""
    kh, kw = kernel.shape
    h, w = img.shape
    oh, ow = h - kh + 1, w - kw + 1
    s = img.strides
    windows = np.lib.stride_tricks.as_strided(
        img, shape=(oh, ow, kh, kw), strides=(s[0], s[1], s[0], s[1]), writeable=False
    )
    return np.einsum("ijkl,kl->ij", windows, kernel)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM between two images ([H,W], [H,W,3] or [H,W,4] uint8/float)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a = a[..., :3].mean(axis=-1)
        b = b[..., :3].mean(axis=-1)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_a2 = _filter2(a * a, k) - mu_a2
    sigma_b2 = _filter2(b * b, k) - mu_b2
    sigma_ab = _filter2(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    return float((num / den).mean())
