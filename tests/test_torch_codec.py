"""The port's host codec (csrc/host/codec.cpp over ctypes) and native ops
against TensorFlow, the JAX package's native build and their numpy versions,
on the CPU.

JPEG decoding matches `tf.io.decode_image`'s defaults (libjpeg's IFAST IDCT,
fancy upsampling) bit for bit here, and the encoder writes TF's bytes; PNG
is bit-exact; the lanczos3 resize and the crop-resize-jitter augment are held
to at most 1 level of TF's ops, given TF's own draws."""

import io
import struct
import zlib

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from intact_tpu.data import tf_transforms as jtft  # noqa: E402
from intact_tpu_torch import native  # noqa: E402
from intact_tpu_torch.data import codec  # noqa: E402


def structured(h, w, seed=0):
    """Gradients, flat rectangles and noise: content that exercises every DCT band."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / max(w, 1) * 255, yy / max(h, 1) * 255, (xx + yy) / (h + w) * 255], -1)
    img += r.normal(0, 12, img.shape)
    for _ in range(6):
        y0, x0 = r.integers(0, h), r.integers(0, w)
        img[y0:y0 + max(1, h // 5), x0:x0 + max(1, w // 6)] = r.integers(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def tf_decode(data: bytes) -> np.ndarray:
    return tf.io.decode_image(data, channels=3, expand_animations=False).numpy()


SHAPES = [(256, 256), (257, 255), (31, 17), (8, 8), (1, 1), (3, 50)]


@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_decode_and_encode_match_tf(shape, quality, subsample):
    img = structured(*shape, seed=shape[0])
    ref_bytes = tf.io.encode_jpeg(img, quality=quality, chroma_downsampling=subsample).numpy()
    ref = tf_decode(ref_bytes)
    np.testing.assert_array_equal(codec.decode_image(ref_bytes), ref)  # IFAST + fancy upsampling, bit-exact
    ours = codec.encode_jpeg(img, quality, subsample)
    assert int(np.abs(tf_decode(ours).astype(int) - ref).max()) <= 1
    assert ours == ref_bytes  # libjpeg's tables, DCT, quantizer and padding: the same bytes


def test_jpeg_gray_replicates():
    gray = structured(40, 33)[..., :1]
    data = tf.io.encode_jpeg(gray, quality=90).numpy()
    out = codec.decode_image(data)
    np.testing.assert_array_equal(out, tf_decode(data))
    assert np.array_equal(out[..., 0], out[..., 2])


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_jpeg_restart_intervals(interval):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(1).integers(0, 256, (45, 70, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                    cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    data = enc.tobytes()
    assert ok and b"\xff\xdd" in data  # a DRI segment
    np.testing.assert_array_equal(codec.decode_image(data), tf_decode(data))


def test_jpeg_422_decodes():
    image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    image.fromarray(structured(45, 70)).save(buf, "JPEG", quality=90, subsampling=1)  # 4:2:2 (h2v1)
    np.testing.assert_array_equal(codec.decode_image(buf.getvalue()), tf_decode(buf.getvalue()))


def test_unsupported_jpeg_and_png_raise():
    image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    image.fromarray(structured(16, 16)).save(buf, "JPEG", progressive=True)
    with pytest.raises(codec.CodecError, match="progressive JPEG .SOF2"):
        codec.decode_image(buf.getvalue())
    base = codec.encode_jpeg(structured(16, 16))
    arith = base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    with pytest.raises(codec.CodecError, match="arithmetic-coded JPEG .SOF9"):
        codec.decode_image(arith)
    twelve = bytearray(base)
    twelve[base.index(b"\xff\xc0") + 4] = 12
    with pytest.raises(codec.CodecError, match="12-bit JPEG"):
        codec.decode_image(bytes(twelve))

    def png(depth, interlace):
        head = struct.pack(">IIBBBBB", 4, 4, depth, 2, 0, 0, interlace)
        chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
        return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + chunk(b"IDAT", zlib.compress(b"\0" * 64)) + \
            chunk(b"IEND", b"")

    with pytest.raises(codec.CodecError, match="16-bit PNG"):
        codec.decode_image(png(16, 0))
    with pytest.raises(codec.CodecError, match="Adam7"):
        codec.decode_image(png(8, 1))
    with pytest.raises(codec.CodecError, match="unknown image format"):
        codec.decode_image(b"GIF89a....")


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_matches_tf(channels):
    img = np.random.default_rng(channels).integers(0, 256, (23, 19, channels), dtype=np.uint8)
    data = tf.io.encode_png(img).numpy()
    np.testing.assert_array_equal(codec.decode_image(data), tf_decode(data))
    np.testing.assert_array_equal(tf.io.decode_png(codec.encode_png(img)).numpy(), img)  # our bytes, TF's reader


def test_png_all_filters():
    """Rows with each of the five filter types (PIL chooses per row)."""
    image = pytest.importorskip("PIL.Image")
    img = structured(37, 41)
    for opt in (True, False):
        buf = io.BytesIO()
        image.fromarray(img).save(buf, "PNG", optimize=opt)
        np.testing.assert_array_equal(codec.decode_image(buf.getvalue()), img)


def test_masked_crc_matches_tfrecord_framing(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    payloads = [b"", b"a", bytes(range(256)) * 9]
    with tf.io.TFRecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    raw = open(path, "rb").read()
    pos = 0
    for p in payloads:
        length = raw[pos:pos + 8]
        assert struct.unpack("<I", raw[pos + 8:pos + 12])[0] == codec.masked_crc32c(length)
        pos += 12
        assert raw[pos:pos + len(p)] == p
        assert struct.unpack("<I", raw[pos + len(p):pos + len(p) + 4])[0] == codec.masked_crc32c(p)
        pos += len(p) + 4


@pytest.mark.parametrize("shapes", [(256, 256, 224, 224), (64, 48, 32, 32), (20, 30, 40, 25), (96, 128, 224, 224)],
                         ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_lanczos3_matches_tf(shapes):
    sh, sw, dh, dw = shapes
    img = np.random.default_rng(sh).integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    ref = jtft.decode_and_resize_tf(tf.constant(img), (dh, dw)).numpy()
    ours = codec.resize_lanczos3(img, (dh, dw))
    assert int(np.abs(ours.astype(int) - ref).max()) <= 1
    assert int(np.abs(ours.astype(int) - codec.resize_lanczos3_reference(img, (dh, dw))).max()) <= 1


@pytest.mark.parametrize("shapes", [(64, 64, 32, 32), (480, 640, 256, 256), (256, 256, 256, 256), (100, 90, 256, 256)],
                         ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_lanczos3_antialias_rounded_matches_tf(shapes):
    """The Octo adapter's resize: antialiased lanczos3, tf.round, clip, cast."""
    sh, sw, dh, dw = shapes
    img = np.random.default_rng(sw).integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    ref = tf.cast(tf.clip_by_value(tf.round(tf.image.resize(tf.cast(img, tf.float32), (dh, dw), method="lanczos3",
                                                            antialias=True)), 0, 255), tf.uint8).numpy()
    np.testing.assert_array_equal(codec.resize_lanczos3(img, (dh, dw), antialias=True, round_even=True), ref)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shapes", [(48, 40, 32, 32), (40, 48, 56, 60), (480, 640, 224, 224), (3, 2, 9, 7)],
                         ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_lanczos4_matches_cv2(shapes, channels):
    """The serving adapters' resize: cv2's INTER_LANCZOS4 on uint8, bit for bit."""
    cv2 = pytest.importorskip("cv2")
    sh, sw, dh, dw = shapes
    img = np.random.default_rng(sh).integers(0, 256, (sh, sw, channels), dtype=np.uint8)
    ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LANCZOS4).reshape(dh, dw, channels)
    np.testing.assert_array_equal(codec.resize_lanczos4(img, (dh, dw)), ref)


def tf_draws(seed) -> codec.JitterDraws:
    """The six draws `_crop_resize_jitter_tf` takes, from TF's own seeds."""
    seeds = tf.unstack(tf.random.experimental.stateless_split(seed, num=6), num=6)
    u = lambda i, lo, hi, n=(): tf.random.stateless_uniform(n, seeds[i], lo, hi).numpy()
    off = u(1, 0.0, 1.0, [2])
    return codec.JitterDraws(u(0, 0.8, 1.0), off[0], off[1], u(2, -0.1, 0.1), u(3, 0.9, 1.1), u(4, 0.9, 1.1),
                             u(5, -0.05, 0.05))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shapes", [(256, 256, 224, 224), (48, 64, 32, 32), (30, 20, 17, 23)],
                         ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_crop_resize_jitter_matches_tf(shapes, seed):
    sh, sw, dh, dw = shapes
    img = structured(sh, sw, seed)
    data = codec.encode_jpeg(img)
    tf_seed = tf.constant([seed, 7], tf.int32)
    ref = jtft.decode_augment_resize_tf(tf.constant(data), (dh, dw), tf_seed).numpy()
    draws = tf_draws(tf_seed)
    ours = codec.crop_resize_jitter(codec.decode_image(data), (dh, dw), draws)
    diff = np.abs(ours.astype(int) - ref)
    assert int(diff.max()) <= 1 and (diff > 0).mean() < 1e-3
    plain = codec.crop_resize_jitter_reference(codec.decode_image(data), (dh, dw), draws)
    assert int(np.abs(ours.astype(int) - plain).max()) <= 1


def test_jitter_draw_ranges():
    rng = np.random.default_rng(0)
    d = np.array([codec.JitterDraws.sample(rng) for _ in range(2000)])
    lo = np.array([0.8, 0, 0, -0.1, 0.9, 0.9, -0.05])
    hi = np.array([1.0, 1, 1, 0.1, 1.1, 1.1, 0.05])
    assert (d >= lo).all() and (d <= hi).all()
    # uniform: each draw's mean within 4 standard errors of the midpoint
    se = (hi - lo) / np.sqrt(12 * len(d))
    assert (np.abs(d.mean(0) - (lo + hi) / 2) < 4 * se).all()


def test_padding_camera_stays_zero():
    from intact_tpu_torch.data import tf_transforms as ttft

    draws = codec.JitterDraws(0.9, 0.5, 0.5, 0.1, 1.1, 1.1, 0.05)
    assert not ttft.decode_augment_resize(b"", (16, 16), draws).any()
    assert not ttft.decode_and_resize(b"", (16, 16)).any()


class TestNative:
    """intact_tpu_torch.native built from its own fastops.cpp into _build/,
    bit-equal to intact_tpu.native (same source, same g++ flags)."""

    def test_builds_into_build_dir(self):
        from intact_tpu_torch.ops import build

        native.library()
        path = build._target("fastops")
        assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "intact_tpu_torch"

    @pytest.mark.parametrize("shape", [(17, 9, 3), (224, 224, 3), (2, 5, 5, 3)])
    def test_normalize_bit_equal_to_jax_native(self, shape):
        from intact_tpu import native as jnative

        img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
        out = native.normalize_u8(img)
        np.testing.assert_array_equal(out, jnative.normalize_u8(img))
        assert out.dtype == np.float32
        assert np.abs(out - native.normalize_u8_reference(img)).max() <= 2.0 ** -23  # one ulp: the FMA

    @pytest.mark.parametrize("dst", [(32, 24), (64, 48), (100, 70)])
    def test_resize_bit_equal_to_jax_native(self, dst):
        from intact_tpu import native as jnative

        img = np.random.default_rng(1).integers(0, 256, (64, 48, 3)).astype(np.uint8)
        out = native.resize_bilinear(img, *dst)
        np.testing.assert_array_equal(out, jnative.resize_bilinear(img, *dst))
        assert int(np.abs(out.astype(int) - native.resize_bilinear_reference(img, *dst)).max()) <= 1

    def test_assemble_batch_bit_equal_to_jax_native(self):
        from intact_tpu import native as jnative

        rng = np.random.default_rng(2)
        frames = [rng.integers(0, 256, s).astype(np.uint8) for s in [(64, 64, 3), (32, 40, 3), (64, 64, 3)]]
        np.testing.assert_array_equal(native.assemble_batch(frames, 64, 64), jnative.assemble_batch(frames, 64, 64))
