"""Writes the JPEG fixtures of this directory and PIL's decode of each as a PNG.

    python tests/torch_port_data/make_jpeg_fixtures.py

The machine with the card has neither PIL nor libjpeg, so `chip_smoke.py`
holds the port's JPEG decoder against these PNGs there;
`tests/test_torch_port_imageio.py::test_committed_fixtures_match_pil` checks
here that each PNG still equals PIL's decode. Sizes are no multiple of the
MCU; the images are smooth colour fields with seeded noise.
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
# name -> (height, width, grey, PIL save options)
FIXTURES = {
    "baseline_420": (45, 67, False, dict(quality=85, subsampling=2)),
    "restart_422": (38, 71, False, dict(quality=90, subsampling=1, restart_marker_blocks=2)),
    "progressive_420": (41, 59, False, dict(quality=80, subsampling=2, progressive=True)),
    "grey": (29, 43, True, dict(quality=90)),
}


def smooth_image(rng, height: int, width: int) -> Image.Image:
    """A bicubic upsampling of a coarse random field, with +-12 of noise."""
    coarse = rng.integers(0, 256, (height // 8 + 2, width // 8 + 2, 3), dtype=np.uint8)
    field = np.asarray(Image.fromarray(coarse).resize((width, height), Image.BICUBIC), np.int16)
    return Image.fromarray(np.clip(field + rng.integers(-12, 13, field.shape), 0, 255).astype(np.uint8))


def main() -> None:
    rng = np.random.default_rng(8)
    for name, (height, width, grey, options) in FIXTURES.items():
        img = smooth_image(rng, height, width)
        jpg, png = os.path.join(HERE, f"{name}.jpg"), os.path.join(HERE, f"{name}.png")
        (img.convert("L") if grey else img).save(jpg, **options)
        Image.open(jpg).convert("RGB").save(png)


if __name__ == "__main__":
    main()
