"""The plain reference: the golden files (sha256 of the JAX package's
``jpegtpu.encode`` of integer-generated 1920x1080 images, which the
repository's tests pin), the port's CPU path at small sizes, and the
control in float32, which has to differ."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import frames
from portbench.reference import jpeg

# sha256 of the JAX package's encode at quality 90 of the images below:
# (mode, restart interval, image) -> digest.
GOLDEN = {
    ("420", "rows", "rings"):
        "09075b2c8fee7778657b237bee596408452841144052381a2947bb0419199dea",
    ("420", 0, "rings"):
        "edbb1641a3d47cf8c9cd5ec5e3f42843acf5b2ed5b8e5985d2a833ff72b45618",
    ("422", "rows", "rings422"):
        "8c5397c934809701caca680ca950d1df0880fb67ae74b9122e1e1055bfbc20a1",
    ("444", "rows", "blocks"):
        "f4feda11a921149a509522b9cb15ed8e1fa9ffaf1a30afe54c27444d04a9b6fa",
    ("444s", "rows", "blocks"):
        "13ba1f350516e279e1db13f3c4985440ea2584c3f025559b0dddd79ca9fd8c19",
}
RINGS = {"rings": ((1104, 876, 1088), (304, 476, 1185), (804, 776, 1282)),
         "rings422": ((1515, 961, 1168), (346, 254, 1268),
                      (1343, 990, 1220))}


def golden_image(name: str, h: int = 1080, w: int = 1920) -> np.ndarray:
    """Elliptic rings in integer arithmetic, or blocks whose only nonzero
    coefficients have exact values far from x.5 at q90 (so that no
    coefficient lies near a rounding tie)."""
    if name in RINGS:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
        return np.stack([((xx - cx) ** 2 + 2 * (yy - cy) ** 2) // d % 256
                         for cx, cy, d in RINGS[name]], -1).astype(np.uint8)
    by, bx = np.mgrid[0:h // 8, 0:w // 8].astype(np.int64)
    s = np.array([1, -1, -1, 1, 1, -1, -1, 1])
    sx, sy = s[None, None, None, :], s[None, :, None, None]
    out = []
    for ch in range(2):
        k = (by * 7919 + bx * 104729 + by * bx * 31 + ch * 65537) % 1000003
        a = 40 + k % 176
        amp = np.minimum(a, 255 - a) // 3
        b, c, d = ((k // m % 3 - 1) * amp for m in (176, 528, 1584))
        e = lambda t: t[:, None, :, None]  # noqa: E731
        blk = e(a) + e(b) * sx + e(c) * sy + e(d) * sx * sy
        out.append(blk.reshape(h, w).astype(np.uint8))
    return np.stack([out[0], out[1], out[1]], axis=-1)


@pytest.mark.parametrize("mode,restart,image", list(GOLDEN))
def test_reference_reproduces_golden_files(mode, restart, image):
    f = jpeg.encode(torch.from_numpy(golden_image(image)), 90, mode, restart)
    assert hashlib.sha256(f).hexdigest() == GOLDEN[(mode, restart, image)]


@pytest.mark.parametrize("h,w", [(40, 64), (17, 33), (5, 3), (16, 16),
                                 (24, 40)])
@pytest.mark.parametrize("mode", ["420", "422", "444"])
@pytest.mark.parametrize("restart", ["rows", 0, 1, 7])
def test_reference_equals_port_cpu_path(h, w, mode, restart):
    jpegtpu_torch = pytest.importorskip("jpegtpu_torch")
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for q in (90, 50):
        want = jpegtpu_torch.encode(img, quality=q, subsampling=mode,
                                    restart_interval=restart, device="cpu")
        assert jpeg.encode(torch.from_numpy(img), q, mode, restart) == want


def test_reference_equals_port_batch_files():
    """The batch configuration's mode: 8 same-shaped frames through
    encode_batch (one program), each file the reference's."""
    jpegtpu_torch = pytest.importorskip("jpegtpu_torch")
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (24, 48, 3), dtype=np.uint8)
            for _ in range(8)]
    files = jpegtpu_torch.encode_batch(imgs, quality=90, subsampling="420",
                                       device="cpu")
    assert files == [jpeg.encode(torch.from_numpy(x), 90, "420", "rows")
                     for x in imgs]


def test_float32_control_differs():
    """The reference with its pixel product in float32 codes some
    coefficients of noisy 1080p content differently, so its scan differs
    from the float64 one (the control, ``portbench/control.py``)."""
    cfg = {"width": 1920, "height": 1080, "batch": 1, "distinct": 1,
           "canvas": [1080, 1920], "noise_sd": 12.0}
    img = frames.make_inputs(cfg, 7, torch.device("cpu"))[0]
    c64, c32 = (jpeg.coefficients(img, 90, "420", dt)
                for dt in (torch.float64, torch.float32))
    assert int((c64 != c32).sum()) > 0
    assert jpeg.scan(img, 90, "420", 120) != jpeg.scan(
        img, 90, "420", 120, torch.float32)
