"""IO tests: weight round-trip, image quantization, native C++ extension."""

import numpy as np
import pytest

from nerf_rs_tpu.io.image import load_ppm, pixels_to_rgba, quantize_u8, save_ppm
from nerf_rs_tpu.io.weights import (
    load_nerf_params,
    read_shapes,
    save_nerf_params,
    validate_param_shapes,
)
from nerf_rs_tpu.models.mlp import init_nerf_params

import jax


def test_weight_roundtrip(tmp_path):
    params = init_nerf_params(jax.random.key(0))
    save_nerf_params(tmp_path / "net", params)
    loaded = load_nerf_params(tmp_path / "net")
    validate_param_shapes(loaded)
    for layer in params:
        np.testing.assert_array_equal(np.asarray(params[layer]["kernel"]),
                                      loaded[layer]["kernel"])
        np.testing.assert_array_equal(np.asarray(params[layer]["bias"]),
                                      loaded[layer]["bias"])


def test_shapes_txt_format(tmp_path):
    params = init_nerf_params(jax.random.key(1))
    save_nerf_params(tmp_path / "net", params)
    entries = dict(read_shapes(tmp_path / "net" / "shapes.txt"))
    assert entries["dense0_kernel"] == (63, 256)
    assert entries["alpha_bias"] == (1,)
    assert len(entries) == 24


def test_quantization_formula():
    px = np.array([-0.5, 0.0, 0.5, 1.0, 2.0, 0.001, 0.9999], np.float32)
    q = quantize_u8(px)
    # clamp*255+0.5 truncated (reference lib.rs:574-577)
    np.testing.assert_array_equal(q, [0, 0, 128, 255, 255, 0, 255])


def test_ppm_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(size=(16, 24, 3)).astype(np.float32)
    save_ppm(tmp_path / "x.ppm", img, 16, 24)
    back = load_ppm(tmp_path / "x.ppm")
    assert back.shape == (16, 24, 3)
    np.testing.assert_allclose(back, quantize_u8(img) / 255.0, atol=1e-7)


def test_rgba_conversion():
    img = np.array([[0.0, 0.5, 1.0]], np.float32)
    rgba = pixels_to_rgba(img)
    np.testing.assert_array_equal(rgba, [0, 128, 255, 255])


# ---------- native C++ extension ----------

def _native():
    from nerf_rs_tpu.io import native

    if not native.available():
        pytest.skip("native IO extension not built (no toolchain?)")
    return native


def test_native_read_matches_numpy(tmp_path):
    native = _native()
    data = np.random.default_rng(2).normal(size=(37, 11)).astype("<f4")
    data.tofile(tmp_path / "t.bin")
    got = native.read_tensor_f32(str(tmp_path / "t.bin"), (37, 11))
    np.testing.assert_array_equal(got, data)


def test_native_quantize_matches_numpy():
    native = _native()
    px = np.random.default_rng(3).uniform(-0.2, 1.2, size=(999,)).astype(np.float32)
    np.testing.assert_array_equal(native.quantize_u8(px), quantize_u8(px))


def test_native_rgba_matches_numpy():
    native = _native()
    px = np.random.default_rng(4).uniform(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.rgb_to_rgba(px), pixels_to_rgba(px))


def test_native_ppm(tmp_path):
    native = _native()
    img = np.random.default_rng(5).uniform(size=(8, 8, 3)).astype(np.float32)
    native.write_ppm(str(tmp_path / "n.ppm"), quantize_u8(img))
    back = load_ppm(tmp_path / "n.ppm")
    np.testing.assert_allclose(back, quantize_u8(img) / 255.0, atol=1e-7)


def test_bundle_roundtrip(tmp_path):
    """save_bundle/load_bundle: one .npz holds both networks + golden JSON
    (the wasm weight-embedding analogue, reference src/weights.rs:1-100)."""
    import json

    from nerf_rs_tpu.io.weights import load_bundle, load_scene_assets, save_bundle

    coarse = init_nerf_params(jax.random.key(0))
    fine = init_nerf_params(jax.random.key(1))
    golden = {"hwf": [400, 400, 555.0], "near": 2.0, "far": 6.0}
    path = tmp_path / "scene.npz"
    save_bundle(path, coarse, fine, json.dumps(golden))

    params, got_golden = load_bundle(path, device_put=False)
    assert got_golden == golden
    for net, src in (("coarse", coarse), ("fine", fine)):
        validate_param_shapes(params[net])
        for layer in src:
            np.testing.assert_array_equal(
                np.asarray(src[layer]["kernel"]), params[net][layer]["kernel"])

    # load_scene_assets dispatches on file-vs-directory transparently.
    params2, golden2 = load_scene_assets(path, device_put=False)
    assert golden2 == golden
    np.testing.assert_array_equal(params2["fine"]["rgb"]["bias"],
                                  params["fine"]["rgb"]["bias"])


def test_find_lego_assets_npz(tmp_path, monkeypatch):
    import json

    from nerf_rs_tpu.io.weights import ASSET_ENV_VAR, find_lego_assets, save_bundle

    path = tmp_path / "scene.npz"
    save_bundle(path, init_nerf_params(jax.random.key(0)),
                init_nerf_params(jax.random.key(1)), json.dumps({}))
    monkeypatch.setenv(ASSET_ENV_VAR, str(path))
    assert find_lego_assets() == path


# ---------- PNG (stdlib zlib codec) ----------

def _png_bytes(img, filters):
    """A PNG written here from the spec with the given per-row filter
    types (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), byte by byte."""
    import struct
    import zlib

    h, w, c = img.shape
    raw = bytearray()
    prev = [0] * (w * c)
    for y in range(h):
        row = [int(v) for v in img[y].reshape(-1)]
        ft = filters[y % len(filters)]
        out = []
        for i, x in enumerate(row):
            a = row[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
            out.append((x - pred) % 256)
        raw += bytes([ft] + out)
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip(tmp_path, channels):
    from nerf_rs_tpu.io.image import decode_png, encode_png, load_png, save_png

    img = np.random.default_rng(channels).integers(
        0, 256, (13, 7, channels), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    if channels == 3:
        px = img.astype(np.float32) / 255.0
        save_png(tmp_path / "a.png", px, 13, 7)
        np.testing.assert_array_equal(
            np.round(load_png(tmp_path / "a.png") * 255).astype(np.uint8), img)


def test_png_decodes_every_row_filter():
    from nerf_rs_tpu.io.image import decode_png

    img = np.random.default_rng(9).integers(0, 256, (10, 6, 4), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_png_bytes(img, [0, 1, 2, 3, 4])), img)
    rgb = img[..., :3].copy()
    np.testing.assert_array_equal(decode_png(_png_bytes(rgb, [4, 3, 1])), rgb)


def test_png_rejects_unsupported_and_corrupt():
    import struct
    import zlib

    from nerf_rs_tpu.io.image import decode_png, encode_png

    good = encode_png(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + good[6:])
    ihdr = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)   # 16-bit RGB
    bad = (good[:8] + struct.pack(">I", 13) + b"IHDR" + ihdr
           + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF)
           + good[33:])
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bad)
