"""Utility coverage: parity photo texture and warp sweep."""

import numpy as np


def test_photo_texture_real_images():
    from vulkansift_tpu.perf.parity import TEXTURES

    photos = [(n, g) for n, g in TEXTURES if n.startswith("photo_")]
    # The oracle needs >= 4 distinct real photographs (VERDICT round 3);
    # all four libraries shipping them are baked into this image.
    assert len(photos) >= 4, [n for n, _ in photos]
    imgs = []
    for name, gen in photos:
        img = gen(480, 640, seed=3)
        assert img.shape == (480, 640)
        assert img.dtype == np.uint8
        # A real photograph: substantial dynamic range + local structure.
        assert img.std() > 15, name
        imgs.append(img)
    # Families are distinct images, and the seed varies the crop.
    for i in range(len(imgs)):
        for j in range(i + 1, len(imgs)):
            assert not np.array_equal(imgs[i], imgs[j])
    n0, g0 = photos[0]
    assert not np.array_equal(g0(480, 640, seed=1), g0(480, 640, seed=2))


def test_warp_sweep_includes_illumination():
    from vulkansift_tpu.perf.parity import warp_sweep

    img = (np.random.default_rng(0).random((120, 160)) * 255
           ).astype(np.uint8)
    tags = [t for t, _, _ in warp_sweep(img)]
    # Rotation/scale/blur/perspective plus the Leuven-style illumination
    # family (gamma + brightness, identity homography).
    assert sum(t.startswith("gamma") for t in tags) >= 2
    assert "dim50" in tags
    assert len(tags) >= 15
    for tag, img2, hm in warp_sweep(img):
        if tag.startswith("gamma") or tag == "dim50":
            assert np.array_equal(hm, np.eye(3))
            assert img2.shape == img.shape
